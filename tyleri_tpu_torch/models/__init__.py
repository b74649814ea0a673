"""tyleri_tpu_torch.models subpackage."""
