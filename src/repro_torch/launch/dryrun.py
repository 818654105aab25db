"""Dry run: trace every (arch x shape) on the production meshes and record
the memory, FLOP, traffic and collective counts of a step for the
roofline (port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
      --shape train_4k --mesh single          # or --all, --mesh multi

The reference lowers and compiles each step with XLA for 256 / 512
forced host devices (``jit(...).lower().compile()``) and reads XLA's
memory analysis and the optimized HLO. The port's analogue is one trace
of its own step, the same Python and the same aten ops, on ``meta``
tensors: every cell of :func:`~repro_torch.launch.mesh.make_production_mesh`
is a ``meta`` device, params, caches and inputs have shapes and dtypes
and no storage, and ``roofline.trace_analyzer`` counts as the ops run.
So it runs in-process: no device count to lock, no subprocess, no
``XLA_FLAGS``. ``--mesh`` also takes ``one`` (the one-device step, no
mesh) and ``model=M[,data=D][,pod=P]`` (a small mesh of ``meta`` cells),
so the dry run can predict what one card runs.

The JSON keeps the reference's keys where their meaning carries:
``arch``, ``shape``, ``mesh``, ``chips``, ``ok``; ``memory`` for the
busiest cell (``argument_bytes`` its inputs, ``temp_bytes`` its peak of
bytes alive made by the step, ``output_bytes`` / ``alias_bytes`` its
results that are new / that are its inputs, updated in place);
``roofline`` as ``roofline_terms`` returns it, collectives included;
``params_total``, ``params_active``, ``remat``, ``microbatches``,
``hints``, and the failure dict. ``lower_s`` / ``compile_s`` become
``trace_s`` (there is no compile), and ``cost_raw_xla`` and
``code_bytes`` are dropped (no XLA cost model, no generated code). New:
``busiest_cell``, ``peak_bytes_all_cells`` (the peak of bytes alive over
all cells at once, each storage once: what the cells need where they
share one device), ``policy`` and ``cache_layout``.

Per-chip figures are the busiest cell's (the largest roofline term),
not a mean: the port's cells do unequal work (data shard ``sd``'s
replicated ops run on its home cell ``(0, sd)``; the logits are joined
on ``(0, 0)``).

Caches are laid out by ``launch.sharding.cache_shardings``, not by the
reference's ``auto_shardings``: the latter halves every head, so the
port's cells, which compute whole heads, would gather every cache at
every token. The dry run traces the layout the port runs and records
``"cache_layout": "cache_shardings"``. The encoder-decoder model's steps
take no mesh (as the reference's audio prefill and serve paths), so an
audio case runs whole on cell ``(0, 0)``. Results are cached as JSON
under ``--out`` (default ``experiments/dryrun_torch``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import INPUT_SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs import (all_arch_names, decode_window, get_arch,
                                 input_specs, shape_supported)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (LaunchMesh, dp_axes_of, dp_size,
                                     make_launch_mesh, make_production_mesh)
from repro_torch.launch.sharding import cache_shardings, param_shardings
from repro_torch.launch.tensor_parallel import Sharded
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.roofline.analysis import HW, roofline_terms
from repro_torch.roofline.trace_analyzer import TraceCounter

META = torch.device("meta")
Cell = Tuple[int, int]


def abstract_params(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """``init_lm`` / ``init_encdec`` on ``meta`` (shapes and dtypes, no
    values)."""
    init = ed.init_encdec if cfg.family == "audio" else tf.init_lm
    return init(cfg, torch.Generator().manual_seed(0), device=META)


def abstract_caches(cfg: ArchConfig, shape: ShapeConfig, window: int,
                    params_abs=None) -> Dict[str, torch.Tensor]:
    """The decode caches of ``shape``'s batch and length, on ``meta``."""
    B = shape.global_batch
    if cfg.family == "audio":
        frames = torch.empty((B, cfg.encdec.source_len, cfg.d_model),
                             dtype=getattr(torch, cfg.compute_dtype),
                             device=META)
        return ed.init_encdec_caches(cfg, params_abs, frames, shape.seq_len,
                                     window)
    return tf.init_lm_caches(cfg, B, shape.seq_len, window, device=META)


def mesh_of(kind: str) -> Optional[LaunchMesh]:
    """``single`` / ``multi`` (the production meshes), ``one`` (no mesh)
    or ``model=M[,data=D][,pod=P]`` (``meta`` cells)."""
    if kind in ("single", "multi"):
        return make_production_mesh(multi_pod=kind == "multi")
    if kind == "one":
        return None
    sizes = {"model": 1, "data": 1, "pod": 1}
    for part in kind.split(","):
        axis, _, n = part.partition("=")
        if axis not in sizes or not n.isdigit():
            raise ValueError(f"--mesh {kind!r}: expected single, multi, one "
                             "or model=M[,data=D][,pod=P]")
        sizes[axis] = int(n)
    n = sizes["model"] * sizes["data"] * sizes["pod"]
    return make_launch_mesh(**sizes, devices=[META] * n)


def _layout(cfg: ArchConfig, leaves: Dict[str, torch.Tensor], mesh, specs
            ) -> Dict[str, Any]:
    if mesh is None or cfg.family == "audio":
        return leaves
    return {k: Sharded.place(v, mesh, specs[k].spec)
            for k, v in leaves.items()}


def build_case(cfg: ArchConfig, shape: ShapeConfig, mesh,
               lr: float = 1e-2, remat="full", microbatches: int = 1,
               hints: bool = False, decode_2d: bool = False,
               n_clients: Optional[int] = None):
    """Returns ``(fn, args, policy)``: the step and its inputs, params
    and caches laid out on ``mesh`` (``None``: one device, whole)."""
    dp = dp_axes_of(mesh) if mesh is not None else ("data",)
    if n_clients is None:
        n_clients = dp_size(mesh) if mesh is not None else 1
    step_mesh = None if cfg.family == "audio" else mesh
    params = abstract_params(cfg)
    policy = "decode_2d" if (decode_2d and shape.kind == "decode") else "train"
    pspecs = (param_shardings(cfg, params, mesh, policy=policy)
              if mesh is not None else None)
    params = _layout(cfg, params, mesh, pspecs)
    specs = {k: torch.empty(s, dtype=d, device=META)
             for k, (s, d) in input_specs(cfg, shape, n_clients).items()}
    window = decode_window(cfg, shape)

    if shape.kind == "train":
        step = steps_mod.make_train_step(cfg, step_mesh, dp, lr=lr,
                                         remat=remat,
                                         microbatches=microbatches,
                                         hints=hints)
        args = [params, specs["tokens"], specs["labels"],
                specs["client_scores"], specs.get("frames")]
        return step, args, policy

    def caches():
        c = abstract_caches(cfg, shape, window, params)
        if step_mesh is None:
            return c
        return _layout(cfg, c, mesh, cache_shardings(cfg, c, mesh, dp))

    if shape.kind == "prefill":
        if cfg.family == "audio":
            # no incremental encdec prefill: full-sequence forward
            @torch.no_grad()
            def fn(params, tokens, frames):
                logits, _ = ed.encdec_forward(cfg, params, frames, tokens)
                return logits[:, -1, :]
            return fn, [params, specs["tokens"], specs["frames"]], policy
        step = steps_mod.make_prefill_step(cfg, window, step_mesh, dp,
                                           hints=hints)
        # one chunk of the chunked prefill; a ring window caps chunk size
        S = min(shape.seq_len, window) if window else shape.seq_len
        tokens = torch.empty((shape.global_batch, S), dtype=torch.int32,
                             device=META)
        n_valid = torch.empty((), dtype=torch.int32, device=META)
        return step, [params, caches(), tokens, n_valid], policy

    step = steps_mod.make_serve_step(cfg, window, step_mesh, dp, hints=hints)
    return step, [params, caches(), specs["tokens"]], policy


def held(obj: Any, mesh) -> List[Tuple[torch.Tensor, List[Cell]]]:
    """Every tensor in ``obj`` (dicts, lists, :class:`Sharded` leaves)
    with the cells that hold it: a piece its cells, a whole tensor cell
    ``(0, 0)``."""
    out: List[Tuple[torch.Tensor, List[Cell]]] = []

    def walk(x):
        if isinstance(x, Sharded):
            D = dp_size(x.mesh)
            cells: Dict[int, Tuple[torch.Tensor, List[Cell]]] = {}
            for c, p in enumerate(x.pieces):
                cells.setdefault(id(p), (p, []))[1].append(divmod(c, D))
            out.extend(cells.values())
        elif isinstance(x, torch.Tensor):
            out.append((x, [(0, 0)]))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(obj)
    return out


def _result_bytes(result, args, cell: Cell, mesh) -> Tuple[int, int]:
    """(output bytes, alias bytes) of ``cell``: the results it holds that
    are new, and those that are its inputs (updated in place)."""
    inputs = {t.untyped_storage()._cdata for t, _ in held(args, mesh)}
    out = alias = 0
    for t, cells in held(result, mesh):
        if cell in cells:
            n = t.numel() * t.element_size()
            if t.untyped_storage()._cdata in inputs:
                alias += n
            else:
                out += n
    return out, alias


def trace_case(cfg: ArchConfig, shape: ShapeConfig, mesh, **kw
               ) -> Dict[str, Any]:
    """Trace one step of ``build_case(cfg, shape, mesh, **kw)`` under a
    :class:`TraceCounter`. Returns the counts (``trace_analyzer``
    layout), the roofline terms of the busiest cell and its memory."""
    t0 = time.time()
    fn, args, policy = build_case(cfg, shape, mesh, **kw)
    hw = HW()
    counter = TraceCounter(backward=shape.kind == "train")
    counter.add_inputs(held(args[:1], mesh))            # the params
    if shape.kind in ("prefill", "decode") and cfg.family != "audio":
        counter.add_inputs(held(args[1], mesh))         # the caches
        batch = args[2:]
    else:
        batch = args[1:]
    counter.add_inputs(held(batch, mesh), batch=True)

    def step_s(t):
        return max(t["flops"] / hw.peak_flops, t["memory_bytes"] / hw.hbm_bw,
                   t["collective_bytes"] / hw.link_bw)

    with counter:
        result = fn(*args)
    counts = counter.result(step_s)
    cell = tuple(counts["cell"])
    out_b, alias_b = _result_bytes(result, args, cell, mesh)
    del result, args
    chips = mesh.size if mesh is not None else 1
    coll = {"total_bytes": counts["collective_bytes"],
            "by_kind": counts["collective_by_kind"],
            "counts": counts["collective_counts"]}
    terms = roofline_terms({"flops": counts["flops"],
                            "bytes accessed": counts["memory_bytes"]},
                           coll, chips, cfg, shape, hw)
    return {"chips": chips, "trace_s": round(time.time() - t0, 2),
            "busiest_cell": list(cell), "policy": policy,
            "memory": {"argument_bytes": counts["argument_bytes"],
                       "output_bytes": out_b,
                       "temp_bytes": counts["temp_bytes"],
                       "alias_bytes": alias_b},
            "peak_bytes": counts["peak_bytes"],
            "peak_bytes_all_cells": counts["peak_bytes_all_cells"],
            "roofline": terms, "counts": counts}


@contextlib.contextmanager
def _budget(seconds: Optional[float]):
    """Raise ``TimeoutError`` in the main thread after ``seconds``."""
    if not seconds:
        yield
        return

    def over(signum, frame):
        raise TimeoutError(f"over the {seconds:g} s budget")

    old = signal.signal(signal.SIGALRM, over)
    # again every second: an alarm that lands in a weakref finalizer is
    # reported and dropped there, the next one ends the case
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_case(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, remat="full",
             microbatches: int = 1, tag: str = "",
             hints: bool = False, decode_2d: bool = False,
             budget: Optional[float] = None) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    if not shape_supported(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "unsupported long-context"}
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}_{shape_name}_{mesh_kind}{tag}.json".replace(
        "/", "-").replace("=", "").replace(",", "_")
    path = os.path.join(out_dir, fname)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    try:
        with _budget(budget):
            r = trace_case(cfg, shape, mesh_of(mesh_kind), remat=remat,
                           microbatches=microbatches, hints=hints,
                           decode_2d=decode_2d)
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "chips": r["chips"], "ok": True, "trace_s": r["trace_s"],
            "memory": r["memory"], "roofline": r["roofline"],
            "busiest_cell": r["busiest_cell"],
            "peak_bytes_all_cells": r["peak_bytes_all_cells"],
            "params_total": cfg.param_counts()["total"],
            "params_active": cfg.param_counts()["active"],
            "remat": remat, "microbatches": microbatches, "hints": hints,
            "policy": r["policy"], "cache_layout": "cache_shardings",
        }
    except Exception as e:  # noqa: BLE001 — report failures as data
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "ok": False, "error": f"{type(e).__name__}: {e}",
                  "trace_s": round(time.time() - t0, 2),
                  "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--mesh", default="single",
                    help="single | multi | one | model=M[,data=D][,pod=P]")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) on --mesh")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--hints", action="store_true")
    ap.add_argument("--decode2d", action="store_true")
    ap.add_argument("--budget", type=float, default=None,
                    help="seconds a case may trace before it is recorded "
                         "as over the budget")
    args = ap.parse_args(argv)
    mesh_of(args.mesh)                       # reject a bad --mesh early

    cases = []
    if args.all:
        for arch in all_arch_names():
            for shape in INPUT_SHAPES:
                cases.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cases.append((args.arch, args.shape))

    n_ok = n_fail = 0
    for arch, shape in cases:
        tag = args.tag or ("_hints" if args.hints else "")
        r = run_case(arch, shape, args.mesh, args.out, force=args.force,
                     remat=(False if args.no_remat else args.remat_policy),
                     microbatches=args.microbatches, tag=tag,
                     hints=args.hints, decode_2d=args.decode2d,
                     budget=args.budget)
        status = ("SKIP" if r.get("skipped")
                  else "OK" if r.get("ok") else "FAIL")
        n_ok += status == "OK"
        n_fail += status == "FAIL"
        extra = ""
        if r.get("ok"):
            t = r["roofline"]
            extra = (f" dom={t['dominant']} tc={t['t_compute_s']:.3f}s "
                     f"tm={t['t_memory_s']:.3f}s tx={t['t_collective_s']:.3f}s"
                     f" trace={r['trace_s']}s")
        elif not r.get("skipped"):
            extra = " " + r.get("error", "")[:120]
        print(f"[dryrun] {arch:24s} {shape:12s} {args.mesh:6s} "
              f"{status}{extra}", flush=True)
    print(f"[dryrun] done ok={n_ok} fail={n_fail}")


if __name__ == "__main__":
    main()
