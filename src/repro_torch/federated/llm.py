"""FedCD at LM scale (mode B, DESIGN.md §3 + §14; port of
``repro/federated/llm.py``): the paper's control plane (scores / clone /
delete) driving score-weighted train steps over a population of LM
replicas, on the plan/executor engine.

Each round:
  1. sample K participating clients (their scores weight the loss; 0 =
     not participating — eq 1's mask);
  2. the RoundPlanner gathers the live-model work order and the
     executor runs it — ``engine="llm"`` (default) trains every model
     that has work IN PLACE in its row of a per-layer-stacked
     ``StackedParamBank`` and scores every live row, enqueued without
     waiting for the card; ``engine="legacy"`` keeps the per-model loop
     over dict storage as the equivalence oracle;
  3. per-client token accuracy on a held-out stream -> eq 2-3 scores;
  4. deletions (eq 4 + late rule) and milestone cloning on the registry.

``"llm+pipeline"`` draws round t+1's host inputs (participation + token
batches) while round t's work runs on the card; the EngineSpec
checkpoint fields (``save_every``/``checkpoint_dir``/``resume_from``/
``faults``) give LM runs the elastic cadence of FedCD/FedAvg, in the
reference's checkpoint format.

The trainer runs on the card unless ``device="cpu"`` is asked for. Every
decoder-only family is ported: dense GQA, MoE (Phi-3.5-MoE), MLA with MoE
and the MTP head (DeepSeek-V3), xLSTM (mLSTM and sLSTM blocks) and the
Zamba2 hybrid (Mamba2 groups, a shared attention block with per-site
LoRA). The encoder-decoder model (``family == "audio"``) is refused at
construction: the reference's trainer gives its step no frames and fails
inside it.

``mesh`` (a :class:`~repro_torch.launch.mesh.LaunchMesh`) runs the
steps tensor-parallel (``launch/tensor_parallel.py``). On ``llm`` and
``llm+pipeline`` the bank follows ``lm_bank_shardings``: each leaf split
by the LM specs, the row axis replicated, so every cell keeps all
``max_models`` rows of its piece. ``legacy`` keeps unsharded params on
cell ``(0, 0)`` and passes the mesh to its steps, as the reference's
does. The trainer's device is cell ``(0, 0)``'s: host batches, losses
and accuracies live there, and ``params_of`` (hence the draft rows)
returns rows gathered there. Serving takes no mesh.

``draft_layers`` keeps the serving plane's cluster-shared draft rows
(``serve.draft.DraftBank``: each live model's leading layers, refreshed
in place after every round), which the checkpoint carries and a
``ServeGateway(draft=trainer.draft, ...)`` serves from.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.io import CheckpointError
from repro_torch.checkpoint.state import (CheckpointManager,
                                          latest_checkpoint,
                                          restore_server_state,
                                          save_server_state)
from repro_torch.config import ArchConfig, FedCDConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.lifecycle import apply_deletions, clone_at_milestone
from repro_torch.core.plan import RoundPlanner
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.scores import (init_scores, normalized_scores,
                                     push_accuracies)
from repro_torch.core.spec import EngineSpec
from repro_torch.data.tokens import lm_batch
from repro_torch.device import resolve_device
from repro_torch.federated.executors import (FedLLMExecutor,
                                             LLMLegacyExecutor)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import LaunchMesh, dp_axes_of
from repro_torch.launch.sharding import lm_bank_shardings
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params
from repro_torch.serve.draft import DraftBank

LLM_ENGINES = ("llm", "legacy")


@dataclass
class LLMRoundMetrics:
    round: int
    mean_loss: float                # NaN when no model trained
    client_acc: np.ndarray          # (N,) best-model token accuracy
    live_models: int
    active_models: int
    score_std: float
    wall_s: float
    trained_models: int = 0         # models with nonzero eq-1 mass


def make_acc_step(cfg: ArchConfig, n_clients: int, mesh=None,
                  dp_axes=("data",), batch_size: Optional[int] = None):
    """Per-client next-token top-1 accuracy (the LM analogue of the
    paper's validation accuracy); argmax ties go to the first index, as
    ``jnp.argmax``.

    The per-client reduction reshapes the batch to
    ``(n_clients, B // n_clients)`` — rows are grouped by client, so a
    batch size that ``n_clients`` does not divide would silently mix
    clients' rows into the wrong accuracy slots. Pass ``batch_size`` to
    reject that at construction; the returned step re-checks the actual
    batch at every call either way."""
    if batch_size is not None and batch_size % n_clients:
        raise ValueError(
            f"eval batch size {batch_size} is not divisible by "
            f"n_clients={n_clients}: per-client accuracy rows would "
            "silently mix clients (rows are grouped per client)")

    @torch.no_grad()
    def step(params, tokens, labels):
        B = tokens.shape[0]
        if B % n_clients:
            raise ValueError(
                f"eval batch size {B} is not divisible by "
                f"n_clients={n_clients}: per-client accuracy rows would "
                "silently mix clients (rows are grouped per client)")
        logits, _, _ = tf.lm_forward(cfg, params, tokens, mesh=mesh,
                                     dp_axes=dp_axes)
        pred = torch.argmax(logits, dim=-1)
        acc = (pred == labels).float().mean(dim=-1)          # (B,)
        return acc.reshape(n_clients, B // n_clients).mean(dim=-1)

    return step


def _trainer_device(device: Optional[Union[str, torch.device]],
                    mesh: Optional[LaunchMesh]) -> torch.device:
    """The trainer's device: ``device`` (default the card), or cell
    ``(0, 0)`` of ``mesh``; given both, they must name one device."""
    if mesh is None:
        return resolve_device(device)
    home = mesh.device(0, 0)
    if device is not None:
        dev = resolve_device(device)
        idx = (lambda d: d.index or 0) if dev.type == "cuda" else \
            (lambda d: None)
        if dev.type != home.type or idx(dev) != idx(home):
            raise ValueError(f"device={dev} and the mesh's cell (0, 0) on "
                             f"{home} disagree")
    return home


def _adopt_init(arch: ArchConfig, init_params: Any,
                device: torch.device) -> Params:
    """``init_params`` (the reference's pytree as numpy, or a flat param
    dict of tensors) -> the port's flat dict on ``device``, each leaf in
    its dtype of ``init_lm`` (``transformer.param_dtype``: the float32
    leaves of a bfloat16 model stay float32), as new tensors the trainer
    owns."""
    flat = (dict(init_params)
            if isinstance(init_params, dict) and all(
                isinstance(v, torch.Tensor) for v in init_params.values())
            else params_from_jax(init_params))
    return {k: v.to(device=device, dtype=tf.param_dtype(arch, k), copy=True)
            for k, v in flat.items()}


class FedLLMTrainer:
    """Mode-B FedCD over a fleet of LM replicas (module docstring).

    ``spec``: an :class:`~repro_torch.core.spec.EngineSpec` (or preset
    string) with ``engine`` in ``("llm", "legacy")``; ``"llm"`` (default)
    is the stacked engine, ``"legacy"`` the per-model loop oracle.
    ``device``: where the models live (default the card).
    ``init_params``: the initial model — the reference's ``init_lm``
    pytree as numpy arrays (through :mod:`repro_torch.convert`) or a flat
    param dict; ``None`` draws the port's own from ``seed``.
    ``draft_layers``: keep draft rows of that depth (module docstring).
    ``mesh``: a tensor-parallel launch mesh (module docstring); with
    ``device`` too, the two must agree on cell ``(0, 0)``."""

    def __init__(self, arch: ArchConfig, fed: FedCDConfig, n_clients: int,
                 per_client: int, seq: int, n_archetypes: int = 2,
                 mesh=None, seed: int = 0,
                 spec: "EngineSpec | str" = "llm",
                 draft_layers: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 init_params: Any = None):
        spec = EngineSpec.coerce(spec)
        if spec.engine not in LLM_ENGINES:
            raise ValueError(
                f"FedLLMTrainer supports engine='llm' (stacked) or "
                f"'legacy' (per-model loop oracle): got {spec.engine!r} "
                "— the mode-A engines live on FedCDServer")
        if mesh is not None and not isinstance(mesh, LaunchMesh):
            raise TypeError(f"mesh must be a LaunchMesh, got "
                            f"{type(mesh).__name__}")
        if arch.family == "audio":
            raise ValueError(
                f"FedLLMTrainer cannot train {arch.name}: an audio model "
                "needs encoder frames, which the trainer's step is never "
                "given (the reference's fails inside the step on them)")
        self.spec = spec
        self.arch, self.fed = arch, fed
        self.n_clients, self.per_client, self.seq = n_clients, per_client, seq
        self.n_archetypes = n_archetypes
        self.mesh = mesh
        self.device = _trainer_device(device, mesh)
        self.pipeline = spec.pipeline
        self.rng = np.random.default_rng(seed)
        init = (tf.init_lm(arch, torch.Generator().manual_seed(seed),
                           device=self.device)
                if init_params is None
                else _adopt_init(arch, init_params, self.device))
        stacked = spec.engine == "llm"
        shardings = (lm_bank_shardings(arch, init, mesh)
                     if stacked and mesh is not None else None)
        self.registry = ModelRegistry.create(
            init, fed.max_models, stacked=stacked, shardings=shardings)
        del init                     # the bank holds its own copy
        self.state = init_scores(n_clients, fed.max_models, fed.score_window)
        dp = ("data",) if mesh is None else dp_axes_of(mesh)
        train_fn = steps_mod.make_train_step(arch, mesh, dp, lr=fed.lr,
                                             remat=False)
        acc_fn = make_acc_step(arch, n_clients, mesh, dp,
                               batch_size=n_clients * per_client)
        cls = FedLLMExecutor if spec.engine == "llm" else LLMLegacyExecutor
        self.executor = cls(fed, self.registry, n_clients, train_fn, acc_fn,
                            device=self.device)
        self.planner = RoundPlanner(fed, n_devices=n_clients)
        # mode B has no minibatch schedule — the plan's perms slot is a
        # fixed placeholder (each round is one step over one batch)
        self._perms = np.zeros((n_clients, 1, 1), np.int32)
        self._prefetch = None
        self.metrics: List[LLMRoundMetrics] = []
        # cluster-shared draft rows for speculative serving (DESIGN.md
        # §16): population state refreshed after every round's clone/
        # delete pass and snapshotted with the trainer checkpoint
        self.draft_layers = draft_layers
        if draft_layers:
            self.draft: Optional[DraftBank] = DraftBank(
                arch, draft_layers, fed.max_models,
                self.executor.params_of(self.registry.live_ids()[0]))
            self.draft.refresh(self.registry,
                               params_of=self.executor.params_of)
        else:
            self.draft = None
        # elastic checkpoint/resume + fault injection (DESIGN.md §13)
        self._faults = spec.faults
        self._ckpt = (CheckpointManager(spec.checkpoint_dir,
                                        spec.save_every,
                                        faults=spec.faults)
                      if spec.checkpoint_dir else None)
        if spec.resume_from:
            path = latest_checkpoint(spec.resume_from)
            if path is None:
                raise CheckpointError(
                    f"resume_from={spec.resume_from!r}: no valid "
                    "checkpoint found (torn/corrupt steps are skipped)")
            restore_server_state(self, path)

    def _batch(self):
        return lm_batch(self.rng, self.n_clients, self.per_client, self.seq,
                        self.arch.vocab_size, self.n_archetypes)

    def _draw_inputs(self):
        """One round's host draws, in the reference's stream order:
        participation choice -> train batch -> val batch (training
        consumes no host RNG, so drawing val up front preserves the
        legacy loop's stream walk exactly)."""
        participating = np.zeros(self.n_clients, bool)
        k = min(self.fed.devices_per_round, self.n_clients)
        participating[self.rng.choice(self.n_clients, k,
                                      replace=False)] = True
        tokens, labels = self._batch()
        vt, vl = self._batch()
        return participating, tokens, labels, vt, vl

    def _round_inputs(self, t: int):
        if self._prefetch is not None and self._prefetch[0] == t:
            inputs, self._prefetch = self._prefetch[1:], None
            return inputs
        self._prefetch = None
        return self._draw_inputs()

    def _fault(self, t: int, phase: str) -> None:
        """Fault-injection hook: raise SimulatedCrash when the spec's
        FaultSchedule scripts a crash at (round, phase)."""
        if self._faults is not None:
            self._faults.check(t, phase)

    def _clone_params(self, p: Params) -> Params:
        # a stacked bank copies the parent's row views into the clone's
        # row itself; dict storage needs tensors of the clone's own
        if self.spec.engine == "llm":
            return p
        return {k: v.clone() for k, v in p.items()}

    def run_round(self, t: int) -> LLMRoundMetrics:
        t0 = time.time()
        fed = self.fed
        participating, tokens, labels, vt, vl = self._round_inputs(t)
        c = normalized_scores(self.state)
        plan = self.planner.build(t, (participating, self._perms), c,
                                  self.state, self.registry,
                                  self.executor.plan_hints())
        self._fault(t, "post-plan")
        self.executor.set_batches(tokens, labels, vt, vl)
        self.executor.launch(plan)
        if self.pipeline and t not in fed.milestones:
            # draw round t+1's host inputs while the round runs on the
            # card. NOT across a milestone: clone-score noise draws from
            # this same stream AFTER the val draw, so prefetching there
            # would reorder the walk vs the synchronous trainer.
            self._prefetch = (t + 1,) + self._draw_inputs()
        self._fault(t, "mid-dispatch")
        accs = self.executor.readback().accs
        self.state = push_accuracies(self.state, accs)
        self.state, _ = apply_deletions(self.state, self.registry, t, fed)
        if t in fed.milestones:
            self.state, cloned = clone_at_milestone(
                self.state, self.registry, t, fed, self.rng,
                clone_params_fn=self._clone_params)
            self.executor.on_clones(cloned)
        if self.draft is not None:
            # post-round draft "training": re-truncate from the freshly
            # trained rows, pre-warm clones, drop deleted clusters
            self.draft.refresh(self.registry,
                               params_of=self.executor.params_of)

        losses = self.executor.round_losses
        cn = normalized_scores(self.state)
        best = np.max(np.where(self.state.active, accs, 0.0), axis=1)
        # masked per-client score dispersion (population σ over each
        # client's active models), vectorized over the fleet
        act = self.state.active
        cnt = act.sum(axis=1)
        mu = np.where(act, cn, 0.0).sum(axis=1) / np.maximum(cnt, 1)
        var = (np.where(act, (cn - mu[:, None]) ** 2, 0.0).sum(axis=1)
               / np.maximum(cnt, 1))
        stds = np.sqrt(var)
        stds[cnt == 0] = 0.0
        m = LLMRoundMetrics(
            round=t,
            # NaN, not 0.0: a no-train round must not read as a
            # perfect-loss round
            mean_loss=float(np.mean(losses)) if losses else float("nan"),
            client_acc=best, live_models=len(self.registry.live_ids()),
            active_models=int(self.state.active.sum()),
            score_std=float(stds.mean()), wall_s=time.time() - t0,
            trained_models=len(losses))
        self.metrics.append(m)
        self._fault(t, "post-readback")
        if self._ckpt is not None:
            self._ckpt.maybe_save(self, t)
        return m

    # -- elastic checkpoint/resume (DESIGN.md §13) -------------------------
    def save(self, path: str) -> str:
        """Snapshot the complete logical round state (between rounds)."""
        return save_server_state(self, path)

    def restore(self, path: str) -> int:
        """Restore from a checkpoint directory (or root — resolves to
        its latest valid step); returns the last completed round."""
        resolved = latest_checkpoint(path)
        if resolved is None:
            raise CheckpointError(f"no valid checkpoint under {path!r}")
        return restore_server_state(self, resolved)

    def run(self, rounds: int, log_every: int = 0):
        # a resumed trainer continues from the round after its checkpoint
        for t in range(len(self.metrics) + 1, rounds + 1):
            m = self.run_round(t)
            if log_every and t % log_every == 0:
                print(f"[fedcd-llm] round {t:3d} loss={m.mean_loss:.3f} "
                      f"live={m.live_models} acc={m.client_acc.mean():.3f}",
                      flush=True)
        return self.metrics
