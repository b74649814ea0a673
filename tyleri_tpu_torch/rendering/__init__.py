"""tyleri_tpu_torch.rendering"""
