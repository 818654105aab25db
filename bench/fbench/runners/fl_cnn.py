"""Mode A: rounds of the paper's CNN through ``FedCDServer.run_round`` or
``FedAvgServer.run_round``.

Set-up builds one server from the seed (data by the frozen hierarchical
generator, weights on the device), runs the traffic's ``setup_rounds``
through ``run_round`` and records the rounds the check compares. With a
``cycle`` it saves the server once after the round before the cycle
(``save_server_state``) and runs the cycle once more, so every shape of
the window is warm; the window then replays the cycle on the same
server, restored in place before each pass, outside the round walls, so
every pass does the same work. Without one the window runs on from the
set-up's last round. A round's wall runs from ``run_round``'s entry to
the ``torch.cuda.synchronize()`` after it.

A traced run (``--trace 1``) wraps the program's calls from here: the
planner's host time, the pair training's and the eval matrices' device
time (CUDA events), the host phases (plan, launch, readback, collect);
then, after the window, it profiles ``trace_rounds`` more rounds for the
device trace.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from fbench import check_fl, counts, frozen, peaks, profile, ref_fl
from fbench.timing import Spans

PHASES = ("plan", "launch", "readback", "collect")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_weights(seed: int, model: Dict[str, Any], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The CNN's weights from the seed in one normal draw on the device:
    convolutions HWIO at std sqrt(2 / (9 c_in)), dense (in, out) at 0.05,
    biases zero."""
    chans, image = model["channels"], model["image"]
    shapes, scales, c_in = {}, {}, model["in_channels"]
    for i, c in enumerate(chans):
        shapes[f"conv.{i}"] = (3, 3, c_in, c)
        scales[f"conv.{i}"] = math.sqrt(2.0 / (9 * c_in))
        c_in = c
    flat = (image // 2 ** (len(chans) // 2)) ** 2 * chans[-1]
    shapes["fc1"], scales["fc1"] = (flat, model["dense"]), 0.05
    shapes["fc2"], scales["fc2"] = (model["dense"], model["n_classes"]), 0.05
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.randn(total, generator=gen, device=device)
    params, off = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        params[k] = draw[off:off + n].reshape(s) * scales[k]
        off += n
    for i, c in enumerate(chans):
        params[f"conv_b.{i}"] = torch.zeros(c, device=device)
    params["fc1_b"] = torch.zeros(model["dense"], device=device)
    params["fc2_b"] = torch.zeros(model["n_classes"], device=device)
    return params


class Capture:
    """What a checked round's pair training produced: each step's
    gradients of one pair of each model, drawn from the seed, the first
    step's of every pair, and the trained pairs (copied to the host as
    they come)."""

    def __init__(self) -> None:
        self.on = False
        self.live: List[int] = []

    def start(self, seed: int, t: int) -> None:
        self.on, self.step, self.seed, self.t = True, 0, seed, t
        self.pairs, self.follow, self.follow_grads = [], [], []
        self.grad0 = self.trained = self.val = None
        self.after = {}

    def plan(self, plan) -> None:
        self.pairs = list(zip(plan.pair_model, plan.pair_device))
        rng = np.random.default_rng([self.seed, self.t])
        models = [int(m) for m, _ in self.pairs]
        self.follow = []
        for m in sorted(set(models)):
            ks = [k for k, mm in enumerate(models) if mm == m]
            self.follow.append(ks[int(rng.integers(len(ks)))])

    def grads(self, fn):
        def wrapper(*args, **kwargs):
            g = fn(*args, **kwargs)
            if self.on:
                if self.step == 0:
                    self.grad0 = {k: v.detach().cpu() for k, v in g.items()}
                rows = torch.as_tensor(self.follow, device=next(
                    iter(g.values())).device, dtype=torch.long)
                self.follow_grads.append({k: v[rows].detach().cpu()
                                          for k, v in g.items()})
                self.step += 1
            return g
        return wrapper

    def train(self, fn):
        def wrapper(*args, **kwargs):
            self.step = 0
            out = fn(*args, **kwargs)
            if self.on:
                self.trained = {k: v.detach().cpu() for k, v in out.items()}
            return out
        return wrapper


class Session:
    """One server and what the benchmark records around it."""

    def __init__(self, job, cfg_file: Dict[str, Any],
                 traffic: Dict[str, Any]):
        from repro_torch.config import FedCDConfig
        from repro_torch.core.fedavg import FedAvgServer
        from repro_torch.core.fedcd import FedCDServer
        import repro_torch.federated.simulation as sim
        from repro_torch.models.cnn import cnn_accuracy, cnn_loss

        self.job, self.traffic, self.model = job, traffic, cfg_file["model"]
        self.pop = cfg_file["population"]
        self.fed = dict(cfg_file["fedcd"])
        self.batch = cfg_file["batch_size"]
        self.kind = traffic["algorithm"]
        self.device = torch.device(job.device)
        self.spans = Spans()
        self.plans: List[Any] = []
        self.cap = Capture()
        pair_train = sim._pair_train
        self._restore = [(sim, "_pair_train", pair_train)]

        def spied(loss_fn, lr):
            # the pair trainer's per-step gradient and its output, seen
            # by the check in its rounds (a pass-through elsewhere)
            vmap = sim.vmap
            sim.vmap = lambda f, *a, **k: self.cap.grads(vmap(f, *a, **k))
            try:
                return self.cap.train(pair_train(loss_fn, lr))
            finally:
                sim.vmap = vmap
        sim._pair_train = spied
        if job.trace:
            eval_gathered = sim._eval_gathered
            self._restore.append((sim, "_eval_gathered", eval_gathered))
            sim._pair_train = lambda loss, lr: self.spans.device_span(
                "train", spied(loss, lr))
            sim._eval_gathered = self.spans.device_span("eval",
                                                        eval_gathered)
        self.data = frozen.hierarchical_population(
            job.seed, self.pop["devices_per_archetype"],
            tuple(self.pop["bias_range"]), self.pop["n_train"],
            self.pop["n_val"], self.pop["n_test"], self.pop["noise"])
        cfg = FedCDConfig(**{**self.fed,
                             "milestones": tuple(self.fed["milestones"])},
                          seed=job.seed)
        init = init_weights(job.seed, self.model, self.device)
        self.widths = [v.numel() for v in init.values()]
        cls = FedCDServer if self.kind == "fedcd" else FedAvgServer
        self.srv = cls(cfg, init, cnn_loss, cnn_accuracy, self.data,
                       batch_size=self.batch, spec=traffic["spec"],
                       device=self.device)
        del init
        self._watch_plans()
        if job.trace:
            self._instrument()

    def _watch_plans(self) -> None:
        """Each round's plan: its work pairs for the check in a checked
        round, its counts in a traced run."""
        def watch(fn):
            def wrapper(*args, **kwargs):
                plan = fn(*args, **kwargs)
                if self.cap.on:
                    self.cap.plan(plan)
                if self.spans.on or self.spans.tracing:
                    self.plans.append(plan)
                return plan
            return wrapper
        if self.kind == "fedcd":
            self.srv.planner.build = watch(self.srv.planner.build)
        else:
            self.srv._plan = watch(self.srv._plan)

    # -- traced runs --------------------------------------------------------
    def _instrument(self) -> None:
        srv, ex = self.srv, self.srv.executor
        span = self.spans.host_span
        if self.kind == "fedcd":
            srv.planner.build = span("plan", srv.planner.build)
            ex.collect = span("collect", ex.collect)
        else:
            srv._plan = span("plan", srv._plan)
        ex.launch = span("launch", ex.launch)
        ex.readback = span("readback", ex.readback)

    def plan_counts(self, plan) -> Dict[str, float]:
        """What one round's plan asks of the device, by the benchmark's
        own counts."""
        fwd, train = counts.cnn_flops(self.model["channels"],
                                      self.model["dense"],
                                      self.model["n_classes"],
                                      self.model["image"])
        n_dev = self.data["train"][0].shape[0]
        pairs = len(plan.pair_model)
        steps, b = plan.perms.shape[1], plan.perms.shape[2]
        evals = n_dev * (len(plan.val_stale) * self.pop["n_val"]
                         + len(plan.test_stale) * self.pop["n_test"])
        models = len(plan.agg_models)
        eq1 = counts.eq1_bytes(pairs, self.widths, models)
        out = {"flops": pairs * steps * b * train + evals * fwd,
               "eq1_bytes": eq1,
               "eq1_flops": 2.0 * models * pairs * sum(self.widths),
               "quant_bytes": 0, "quant_ops": 0}
        if self.fed["quantize_bits"] and self.kind == "fedcd" and models:
            rows = [(models, d) for d in self.widths]
            out["quant_bytes"] = (counts.quantize_bytes(rows)
                                  + counts.dequantize_bytes(rows))
            out["quant_ops"] = 7.0 * models * sum(self.widths)
        return out

    # -- records for the check ---------------------------------------------
    def _params(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """Every live model's params, copied to the host."""
        if self.kind == "fedcd":
            reg = self.srv.registry
            return {m: {k: v.detach().cpu().clone()
                        for k, v in reg.params[m].items()}
                    for m in reg.live_ids()}
        return {0: {k: v.detach().cpu().clone()
                    for k, v in self.srv.executor.get_params().items()}}

    def _scores(self) -> ref_fl.Scores:
        if self.kind == "fedcd":
            st = self.srv.state
            return ref_fl.Scores(st.history.copy(), st.active.copy(),
                                 st.alive.copy())
        n_dev = self.data["train"][0].shape[0]
        return ref_fl.Scores(np.zeros((n_dev, 1, 1)),
                             np.ones((n_dev, 1), bool), np.ones(1, bool))

    def _begin(self, t: int) -> check_fl.Record:
        if self.kind == "fedcd":
            reg, cfg = self.srv.registry, self.fed
            entries = reg.entries.values()
            rec = check_fl.Record(
                self._params(), self._scores(), len(reg.entries),
                clones_before=sum(1 for e in entries
                                  if 0 < e.birth_round < t
                                  and e.birth_round in cfg["milestones"]))
        else:
            rec = check_fl.Record(self._params(), self._scores(), 1)
        self.cap.start(self.job.seed, t)
        return rec

    def _end(self, rec: check_fl.Record, t: int, metrics) -> None:
        cap = self.cap
        cap.on = False
        rec.after, rec.val = cap.after, cap.val
        rec.test = np.array(metrics.test_acc)
        rec.pairs, rec.trained, rec.grad0 = cap.pairs, cap.trained, cap.grad0
        rec.follow, rec.follow_grads = cap.follow, cap.follow_grads
        rec.scores_after = self._scores()
        if self.kind == "fedcd":
            reg = self.srv.registry
            rec.clones = {m: {k: v.detach().cpu().clone()
                              for k, v in reg.params[m].items()}
                          for m, e in reg.entries.items()
                          if e.birth_round == t and e.alive}

    def _readback(self, read):
        """The executor's readback, and (while a checked round runs) the
        round's validation matrix and every model's row as the round
        left it, before the lifecycle."""
        def readback():
            res = read()
            if self.cap.on:
                if self.kind == "fedcd":
                    self.cap.val = np.array(res.accs)
                    live = self.cap.live
                    reg = self.srv.registry
                    self.cap.after = {
                        m: {k: v.detach().cpu().clone()
                            for k, v in reg.params[m].items()}
                        for m in live}
                else:
                    self.cap.val = np.array(res.val_acc)[:, None]
                    self.cap.after = self._params()
            return res
        return readback

    def setup(self, ckpt: str) -> Dict[int, check_fl.Record]:
        srv, tr = self.srv, self.traffic
        check = set(tr["check_rounds"])
        recs: Dict[int, check_fl.Record] = {}
        read = srv.executor.readback
        srv.executor.readback = self._readback(read)
        for t in range(1, tr["setup_rounds"] + 1):
            if t in check:
                rec = self._begin(t)
                self.cap.live = sorted(rec.before)
            m = srv.run_round(t)
            _sync(self.device)
            if t in check:
                self._end(rec, t, m)
                recs[t] = rec
            if t == tr.get("save_after"):
                srv.save(ckpt)
        srv.executor.readback = read
        return recs

    def rounds(self, ckpt: str):
        """The window's rounds, endlessly: (round, restore first)."""
        tr = self.traffic
        if tr.get("cycle"):
            a, b = tr["cycle"]
            while True:
                for t in range(a, b + 1):
                    yield t, t == a
        t = tr["setup_rounds"]
        while True:
            t += 1
            yield t, False

    def run_window(self, ckpt: str, seconds: float):
        walls: List[float] = []
        self.spans.on = bool(self.job.trace)
        gen = self.rounds(ckpt)
        t_open = time.perf_counter()
        per_pass = (self.traffic["cycle"][1] - self.traffic["cycle"][0] + 1
                    if self.traffic.get("cycle") else 1)
        while True:
            t, restore = next(gen)
            if restore:
                # the previous pass's garbage goes before the state comes
                # back, so each pass starts from the same live memory
                gc.collect()
                self.srv.restore(ckpt)
            t0 = time.perf_counter()
            self.srv.run_round(t)
            _sync(self.device)
            walls.append(time.perf_counter() - t0)
            self.spans.end_round()
            if (len(walls) % per_pass == 0
                    and time.perf_counter() - t_open >= seconds):
                break
        self.spans.on = False
        return walls, gen

    def traced_rounds(self, ckpt: str, gen, n: int) -> Dict[str, Any]:
        """``n`` more rounds under the profiler (device activity only;
        the host phases are the benchmark's own spans)."""
        self.plans = []
        self.spans.tracing = True
        windows = []
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                t, restore = next(gen)
                if restore:
                    self.srv.restore(ckpt)
                n0 = time.time_ns()
                self.srv.run_round(t)
                _sync(self.device)
                windows.append((n0, time.time_ns()))
        self.spans.tracing = False
        out = profile.analyse(profile.device_events(prof), windows,
                              self.spans.ranges, PHASES)
        c = [self.plan_counts(p) for p in self.plans]
        out["eq1"] = [(x["eq1_bytes"], x["eq1_flops"]) for x in c]
        out["quant"] = [(x["quant_bytes"], x["quant_ops"]) for x in c
                        if x["quant_bytes"]]
        return out

    # -- correct --------------------------------------------------------------
    def check(self, recs: Dict[int, check_fl.Record], tf32: bool = False,
              fault: str = "", detail=None) -> Dict[str, float]:
        """Each checked round: the program (or, with ``tf32`` or
        ``fault``, the control or a planted fault in its place) against
        the reference."""
        dev = self.device
        data = {k: (torch.as_tensor(x, device=dev),
                    torch.as_tensor(y, device=dev))
                for k, (x, y) in self.data.items()}
        samples = frozen.round_samples(
            self.job.seed, max(recs), data["train"][1].shape[0],
            self.fed["devices_per_round"], self.pop["n_train"], self.batch,
            self.fed["local_epochs"])
        fedcd = self.kind == "fedcd"
        parts = []
        for t, rec in sorted(recs.items()):
            args = (rec, t, samples[t], data, self.fed,
                    self.model["channels"], self.job.seed, fedcd)
            ref = check_fl.side(*args)
            prog = (check_fl.side(*args, tf32=tf32, fault=fault)
                    if tf32 or fault else check_fl.program_side(rec))
            parts.append(check_fl.compare(rec, prog, ref, t, detail))
        return check_fl.merge(parts)

    def close(self) -> None:
        """Put back the program's functions the session wrapped."""
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore = []
        self.srv = None


def run(job) -> Dict[str, Any]:
    cell = job.cell
    tf32 = bool(cell.config["model"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    ses = Session(job, cell.config, cell.traffic)
    try:
        return _run(job, ses, t0)
    finally:
        ses.close()


def _run(job, ses: Session, t0: float) -> Dict[str, Any]:
    cell = job.cell
    t1 = time.perf_counter()
    ckpt = os.path.join(job.scratch, "round_state")
    recs = ses.setup(ckpt)
    _sync(ses.device)
    t2 = time.perf_counter()
    setup_s = t2 - job.t_start
    print(f"setup: start {t0 - job.t_start:.3f} s, data and server "
          f"{t1 - t0:.3f} s, {cell.traffic['setup_rounds']} rounds "
          f"{t2 - t1:.3f} s", file=sys.stderr)
    walls, gen = ses.run_window(ckpt, job.seconds)
    print("window walls ms: " + " ".join(f"{1e3 * w:.1f}" for w in walls),
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(ses.device)
            if ses.device.type == "cuda" else 0)
    out: Dict[str, Any] = {
        "attempted": len(walls), "failed": 0, "memory_peak_bytes": peak,
        "end_to_end": {cell.traffic["round_metric"]:
                       1e3 * sum(walls) / len(walls),
                       "setup_s": setup_s,
                       "peak_mem_gib": peak / 2 ** 30},
        "walls": walls}
    if job.trace:
        window_plans = [ses.plan_counts(p) for p in ses.plans]
        traced = ses.traced_rounds(ckpt, gen, cell.traffic["trace_rounds"])
        out["ctx"] = {
            "window": {
                "rounds": len(walls), "wall_s": sum(walls),
                "plan_ms": ses.spans.mean_ms("plan", "host"),
                "train_ms": ses.spans.mean_ms("train", "device"),
                "eval_ms": ses.spans.mean_ms("eval", "device"),
                "flops": sum(c["flops"] for c in window_plans),
                "peak_flops": peaks.FLOPS[cell.config["model"]["dtype"]]},
            "traced": traced}
        out["trace"] = traced
    # the program's state goes before the reference runs
    ses.srv = None
    gc.collect()
    if ses.device.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = ses.check(recs)
    return out
