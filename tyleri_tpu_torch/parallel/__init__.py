"""tyleri_tpu_torch.parallel subpackage."""
