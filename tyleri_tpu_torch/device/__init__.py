"""tyleri_tpu_torch.device"""
