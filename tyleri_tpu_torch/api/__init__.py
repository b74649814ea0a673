"""tyleri_tpu_torch.api subpackage."""
