"""tyleri_tpu_torch.pipeline subpackage."""
