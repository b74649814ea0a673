"""tyleri_tpu_torch.resource"""
