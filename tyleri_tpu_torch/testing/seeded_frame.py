"""A new process, seeded from a pipeline cache, renders one frame.

    python3 -m tyleri_tpu_torch.testing.seeded_frame SEED_FILE [--config 2]
        [--resolution 800x600] [--device cuda] [--spawned-at UNIX_SECONDS]

It builds its device with ``RenderDeviceBuilder().pipeline_cache_data(seed)``
(the seed unpacked into a fresh temporary directory, removed at the end),
renders one frame of BASELINE config 1 or 2 (at its own resolution unless
one is given) through a ``RenderWindow`` and
prints one JSON line: the nvcc and g++ builds it made (``compiles``,
``host_compiles``), the kernel library and the host runtime it loaded and
the cache's directory,
the seconds from ``--spawned-at`` (its parent's clock when it spawned the
process) to the device and to the first presented frame, the kernel
launches, and the image's sha256 (``image_digest``).  ``run`` spawns it
from a seed's bytes and returns that record.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_T0 = time.time()   # the default --spawned-at: this module's import

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# config: (scene rig, its BASELINE resolution, its frame time)
CONFIGS = {1: ("config1_triangle", (512, 512), 0.0),
           2: ("config2_cube", (800, 600), 0.9)}


def image_digest(img) -> str:
    """sha256 of a presented u8 image's shape and bytes."""
    import numpy as np

    arr = np.ascontiguousarray(img, np.uint8)
    return hashlib.sha256(repr(arr.shape).encode() + arr.tobytes()).hexdigest()


def render_one(dev, config: int, resolution=None):
    """One frame of the config on a new window; the presented image."""
    import tyleri_tpu_torch as tt

    make, default, t = CONFIGS[config]
    rig = getattr(tt.scenes, make)(dev, resolution or default)
    win = tt.RenderWindow(dev, resolution=rig.resolution,
                          present_mode="immediate")
    rig.fill(win.get_render_scene(), t)
    win.render()
    return win.flush()


def run(seed: bytes, config: int = 2, resolution=None, device: str = "cuda",
        timeout: float = 600.0) -> dict:
    """Spawn this module on ``seed``; its JSON record."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seed.zip")
        with open(path, "wb") as f:
            f.write(seed)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        cmd = [sys.executable, "-m", "tyleri_tpu_torch.testing.seeded_frame",
               path, "--config", str(config), "--device", device,
               "--spawned-at", repr(time.time())]
        if resolution:
            cmd += ["--resolution", "x".join(map(str, resolution))]
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"seeded_frame exited {out.returncode}:\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seed", help="a file holding pipeline_cache.get_data()")
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS), default=2)
    ap.add_argument("--resolution", default=None, help="WxH")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--spawned-at", type=float, default=_T0)
    args = ap.parse_args(argv)

    from tyleri_tpu_torch import _build, native
    from tyleri_tpu_torch.device.builders import RenderDeviceBuilder

    with open(args.seed, "rb") as f:
        seed = f.read()
    dev = RenderDeviceBuilder().device(args.device).pipeline_cache_data(
        seed).build()
    cache = dev.pipeline_cache
    try:
        device_s = time.time() - args.spawned_at
        res = (tuple(int(v) for v in args.resolution.split("x"))
               if args.resolution else None)
        img = render_one(dev, args.config, res)
        first_frame_s = time.time() - args.spawned_at
        print(json.dumps({
            "compiles": _build.compiles, "host_compiles": native.compiles,
            "enabled": cache.enabled, "directory": cache.directory,
            "library": _build.loaded_path,
            "host_library": (native.library_path() if native.available()
                             else None),
            "device_s": device_s, "first_frame_s": first_frame_s,
            "launches": {
                "fused_setup": _build.launches["fused_setup"],
                "peel2": _build.launches["rasterize_visibility_peel2"]},
            "image_sha256": image_digest(img),
        }))
    finally:
        shutil.rmtree(cache.directory, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
