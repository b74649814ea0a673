"""tyleri_tpu_torch.utils subpackage."""
