"""The control's readings at a cell's own size: for each seed, frames of
the cell's traffic drawn by the reference in float64 and again with its
vertex stage in bfloat16 (the control), compared as a run compares the
program's frames (``compare.numbers``).  The program is not run.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        [--frames 2] [--device cuda]

One JSON line a frame, then the smallest reading of each number over all
of them (a limit must lie below it).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import compare, harness, reference, scene, spec


def _fullest_tile(image):
    """(y, x) of the 16 x 16 tile with the most pixels off the clear
    colour, the first of equals."""
    h, w = image.shape[0] // 16 * 16, image.shape[1] // 16 * 16
    drawn = (image[:h, :w, :3] > 0).any(-1)
    per = drawn.reshape(h // 16, 16, w // 16, 16).sum(axis=(1, 3))
    ty, tx = np.unravel_index(int(per.argmax()), per.shape)
    return int(ty) * 16, int(tx) * 16


def _half(sc):
    """The scene with the second half of each mesh's triangles gone."""
    meshes = [scene.Mesh(m.positions, m.uvs,
                         m.indices[:m.triangle_count // 2 * 3])
              for m in sc.meshes]
    return scene.Scene(sc.resolution, meshes, sc.textures, sc.frame)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    readings = []
    for seed in args.seeds:
        sc = scene.generator(cell.config["generator"]).build(
            cell.config["params"], seed)
        ov = cell.traffic["overlay"]
        overlay = (scene.generator(ov["generator"]).build(ov["params"], seed)
                   if ov else None)
        clock = harness.Clock(cell.traffic["time"], seed)
        clock.first = 0  # the window's frame times, from the seed's start
        picks = harness.rng(seed, 3).choice(240, size=args.frames,
                                            replace=False)
        for k in picks.tolist():
            view = sc.frame(clock(k))
            want = reference.render(sc, view, cell.config, args.device,
                                    overlay)
            low = reference.render(sc, view, cell.config, args.device,
                                   overlay, precision="bf16")
            n = compare.numbers(low, want)
            readings.append(n)
            faults = {}
            # the reference in the program's place, broken: the frame
            # before presented again, the fullest 16 x 16 tile at the clear
            # colour, half of each mesh's triangles left out
            before = reference.render(sc, sc.frame(clock(k - 1)), cell.config,
                                      args.device, overlay)
            faults["stale_frame"] = compare.numbers(before, want)
            lost = want.copy()
            y, x = _fullest_tile(want)
            lost[y:y + 16, x:x + 16, :3] = 0
            faults["one_tile_lost"] = compare.numbers(lost, want)
            half = reference.render(_half(sc), view, cell.config,
                                    args.device, overlay)
            faults["half_the_triangles"] = compare.numbers(half, want)
            print(json.dumps(dict(workload=args.workload, seed=seed, frame=k,
                                  control=n, faults=faults)), flush=True)
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    print(json.dumps(dict(workload=args.workload, control_least=least)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
