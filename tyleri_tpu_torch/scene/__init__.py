"""tyleri_tpu_torch.scene subpackage."""
