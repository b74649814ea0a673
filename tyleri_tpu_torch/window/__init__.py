"""tyleri_tpu_torch.window"""
