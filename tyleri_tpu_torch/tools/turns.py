"""P6 ``fixed_cost`` and P1 ``pipe_cost`` from several kernel libraries, in
turns: each ``--csrc NAME=DIR`` is a source tree of ``csrc/`` (a parent's
``git archive``, or a copy with one kernel in another form), built as the
package builds its own, one build process each, all started together.

Every case is first held bit-equal to its plain version in each library,
then timed as a CUDA graph of ``--reps`` calls in the order A, B, ..., B,
A.  The cases are the tools' variants, P6 on ``segment_starts`` and
``jumbled_starts``, and P1 at tpp 17 and 68 and on ``jumbled_starts``.
One JSON line a case: ``equal`` and ``ms`` by library; the first lines
give each library's ptxas registers and spill bytes of the two kernels,
the last the card's rate on one PyTorch copy of P1's entry table (the
read/write mix of ``v_loop1``'s windows and maps).

    python3 -m tyleri_tpu_torch.tools.turns \\
        --csrc parent=build/parent/tyleri_tpu_torch/csrc \\
        --csrc tree=tyleri_tpu_torch/csrc
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import _common, exp_fixedcost, exp_pipecost

KERNELS = ("fixed_cost_kernel", "pipe_cost_kernel")
_BUILD = ("import sys; sys.path.insert(0, {root!r}); "
          "from tyleri_tpu_torch import _build; _build.CSRC = {csrc!r}; "
          "_build.set_build_dir({bdir!r}); print(_build.build())")


def build_all(trees: dict[str, str], device, card) -> dict:
    """{name: bound library} of the trees that build; a tree nvcc refuses
    gives a line with its error."""
    root = os.path.dirname(os.path.dirname(_build.CSRC))
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-c", _BUILD.format(
                root=root, csrc=os.path.abspath(csrc),
                bdir=os.path.join(_build.build_dir(), "turns", name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, csrc in trees.items()}
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            _common.emit("turns", "build", device, card, library=name,
                         error=err[-3000:])
            continue
        path = out.strip().splitlines()[-1]
        lib = ctypes.CDLL(path)
        _build._bind(lib)
        libs[name] = lib
        with open(_build.report_path(path)) as f:
            found = _build.parse_ptxas(f.read())
        names = [s.split("::")[-1] for s in _build.demangle(list(found))]
        _common.emit("turns", "ptxas", device, card, library=name,
                     **{k: list(v) for k, v in zip(names, found.values())
                        if k.startswith(KERNELS)})
    return libs


def cases(device) -> dict:
    """{case: (kernel call, plain call)}."""
    table, tiny, depth0, ts_empty = exp_fixedcost.tool_inputs(device)
    short = table[:exp_fixedcost.SHORT_E].contiguous()
    seg = exp_fixedcost.segment_starts(device)
    jumbled = exp_fixedcost.jumbled_starts(device)
    p6 = {name: (tiny if kw["tiny"] else table, ts_empty, kw["n_out"])
          for name, kw in exp_fixedcost.VARIANTS.items()}
    p6.update(segments=(table, seg, 7), segments_outs1=(table, seg, 1),
              jumbled=(short, jumbled, 7), jumbled_outs1=(short, jumbled, 1))
    out = {}
    for name, (tab, ts, n) in p6.items():
        out["P6 " + name] = (
            lambda tab=tab, ts=ts, n=n: exp_fixedcost.fixed_cost(
                tab, ts, depth0, n_out=n),
            lambda tab=tab, ts=ts, n=n: exp_fixedcost.fixed_cost_reference(
                tab, ts, depth0, n_out=n))
    entries, ts_zero, ts_one = exp_pipecost.tool_inputs(device)
    pshort = entries[:exp_pipecost.SHORT_E].contiguous()
    pjumbled = exp_pipecost.jumbled_starts(device)
    p1 = {name: (entries, ts_one if kw["ts"] == "one" else ts_zero,
                 kw["level"], kw["nout"], kw["tpp"])
          for name, kw in exp_pipecost.VARIANTS.items()}
    p1.update({"v_loop1_tpp17": (entries, ts_one, 2, 7, 17),
               "v_loop1_tpp68": (entries, ts_one, 2, 7, 68)})
    p1.update({f"jumbled_tpp{tpp}": (pshort, pjumbled, 2, 7, tpp)
               for tpp in (1, 4, 17, 68)})
    for name, (e, ts, level, nout, tpp) in p1.items():
        kw = dict(nout=nout, level=level)
        out["P1 " + name] = (
            lambda e=e, ts=ts, kw=kw, tpp=tpp: exp_pipecost.run(
                e, ts, tpp=tpp, **kw),
            lambda e=e, ts=ts, kw=kw: exp_pipecost.pipe_cost_reference(
                e, ts, **kw))
    return out


def main(argv=None) -> int:
    def options(ap):
        ap.add_argument("--csrc", action="append", default=[],
                        metavar="NAME=DIR", help="a source tree to build "
                        "and time (repeatable; default: the package's)")

    args = _common.parse(argv, __doc__, options)
    device = _common.device_for(args)
    if device.type != "cuda":
        raise RuntimeError("turns times kernels: it needs the card")
    card = _common.card_line()
    trees = dict(s.split("=", 1) for s in args.csrc) or {
        "tree": _build.CSRC}
    libs = build_all(trees, device, card)
    order = list(libs) + list(reversed(libs))
    kept, failed = _build._lib, len(libs) < len(trees)
    try:
        for name, (kernel, plain) in cases(device).items():
            want = plain()
            equal = {}
            for lib_name, lib in libs.items():
                _build._lib = lib
                got = kernel()
                equal[lib_name] = all(
                    torch.equal(g.view(torch.int32), w.view(torch.int32))
                    for g, w in zip(got, want, strict=True))
            del want, got
            failed = failed or not all(equal.values())
            ms = {}
            for lib_name in order:
                if equal[lib_name]:
                    _build._lib = libs[lib_name]
                    ms.setdefault(lib_name, []).append(
                        _common.graph_ms(kernel, args.reps))
            _common.emit("turns", name, device, card, equal=equal, ms=ms)
    finally:
        _build._lib = kept
    # the card's rate on a read/write mix like v_loop1's windows and maps:
    # one PyTorch copy of P1's entry table (50.3 MB read, 50.3 MB written)
    entries = exp_pipecost.tool_inputs(device)[0]
    nbytes = 2 * entries.numel() * entries.element_size()
    copy_ms = _common.graph_ms(entries.clone, args.reps)
    _common.emit("turns", "copy_rate", device, card, ms=copy_ms,
                 bytes=nbytes, tb_per_s=nbytes / copy_ms / 1e9)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
