"""The JAX package's TPU probe tools, ported: each module replaces the tool
of the same name under the repository's ``tools/`` with a hand-written CUDA
kernel (``csrc/probes.cu``), its wrapper, its plain PyTorch version and a
``main()`` that times the tool's variants on the card with CUDA events
around a CUDA graph of the calls:

    python3 -m tyleri_tpu_torch.tools.exp_binning      # P4, row gather
    python3 -m tyleri_tpu_torch.tools.exp_fixed_grid   # P7, K3 init + stores
    python3 -m tyleri_tpu_torch.tools.exp_fixedcost    # P6, K3 empty loop
    python3 -m tyleri_tpu_torch.tools.exp_pipecost     # P1, K3 floor stages

Each prints one JSON line per variant with the card's name and power limit.
Without a card each raises, unless given ``--device cpu``: then the plain
versions run and the line carries host-clock times (``host_ms``), no device
time.
"""
