"""EngineSpec: one typed, validated description of a server's engine
(port of ``repro/core/spec.py``).

The servers take ``spec=`` — an :class:`EngineSpec` or a preset string —
and validate every combination at construction. The grammar, the
validation rules and their ``ValueError``s are the reference's; the
deprecated per-capability kwargs (``engine=``, ``use_agg_kernel=``, ...)
translate through :func:`resolve_spec` as they do there.

String grammar (``EngineSpec.parse``)::

    spec      := engine [ "@" shards ] ( "+" flag )*
    engine    := "fused" | "batched" | "legacy" | "sharded" | "llm"
    shards    := INT | INT "x" INT            # model [x data]
    flag      := "pipeline" | "semisync" | "kernel"
               | "sparse" ":" FLOAT | "migrate" ":" FLOAT

``"sharded"`` is the fused data plane on a launch mesh (``sharded@4`` =
4 model shards; ``sharded@2x2`` = the 2-D model × data mesh; see
:mod:`repro_torch.launch.mesh`). The port runs every spec the reference
runs outside the LM plane: the engines ``fused``, ``batched`` and
``legacy``, with or without ``+kernel``; on ``fused`` and ``sharded``
the pipelined dispatch (``+pipeline``), holder-only validation scoring
(``+sparse:<x>``), semi-synchronous rounds (``+semisync``, which
attaches a default :class:`~repro_torch.data.scenarios.StragglerModel`;
construct the spec directly to tune it) and, for FedCD, device churn
(``scenario=``, a :class:`~repro_torch.data.scenarios.ChurnSchedule`)
and row migration (``+migrate:<x>``, sharded only); on every engine,
elastic checkpoint/resume (``save_every``, ``checkpoint_dir``,
``resume_from``) and scripted crashes (``faults``, a
:class:`~repro_torch.data.scenarios.FaultSchedule`). ``+kernel`` is
accepted and changes nothing: on CUDA tensors the port's hand-written
kernels are always the aggregation path, and their plain versions serve
CPU tensors only. ``engine="llm"`` parses as in the reference, and the
servers refuse it with the reference's ``ValueError`` (it is the LM
trainer's spec).

A sharded spec's mesh is the injected ``mesh`` (a
:class:`~repro_torch.launch.mesh.LaunchMesh`), else
``make_launch_mesh(model_shards, data_shards)`` over that many CUDA
devices — which raises where there are fewer, unless the server was
asked for the CPU: its cells then all lie on the CPU.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from repro_torch.data.scenarios import StragglerModel
from repro_torch.launch.mesh import (data_axis_size, make_launch_mesh,
                                     model_axis_size)

MESHLESS_ENGINES = ("fused", "batched", "legacy")
ENGINES = MESHLESS_ENGINES + ("llm",)


@dataclass(frozen=True)
class EngineSpec:
    """One engine configuration (module docstring for the grammar).

    ``engine`` is one of the meshless engines; sharding is expressed by
    ``model_shards``/``data_shards`` (>1 selects the sharded planes and
    requires ``engine="fused"``). ``mesh`` optionally injects a prebuilt
    :class:`~repro_torch.launch.mesh.LaunchMesh` (tests sharing one mesh
    across servers, cells placed on chosen devices); otherwise
    :meth:`resolve_mesh` builds it from the shard counts."""
    engine: str = "fused"
    model_shards: int = 1
    data_shards: int = 1
    pipeline: bool = False
    sparse_eval: Optional[float] = None
    migrate_threshold: Optional[float] = None
    use_agg_kernel: bool = False
    scenario: Any = None             # ChurnSchedule (FedCD only)
    straggler: Any = None            # StragglerModel (semi-sync rounds)
    # elastic checkpoint/resume and fault injection
    save_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[str] = None
    faults: Any = None               # FaultSchedule (crash injection)
    mesh: Any = field(default=None, compare=False)

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "EngineSpec":
        """Build a spec from the preset grammar (module docstring)."""
        parts = text.strip().split("+")
        head, flags = parts[0], parts[1:]
        engine, _, shard_txt = head.partition("@")
        kw: dict = {}
        if engine == "sharded":
            engine = "fused"
            if not shard_txt:
                raise ValueError(
                    f"{text!r}: 'sharded' needs shard counts — "
                    "e.g. 'sharded@4' or 'sharded@2x2'")
        elif shard_txt:
            raise ValueError(
                f"{text!r}: shard counts ('@{shard_txt}') only apply to "
                "'sharded'")
        if shard_txt:
            m, _, d = shard_txt.partition("x")
            try:
                kw["model_shards"] = int(m)
                kw["data_shards"] = int(d) if d else 1
            except ValueError:
                raise ValueError(
                    f"{text!r}: bad shard counts {shard_txt!r} "
                    "(want INT or INTxINT)") from None
        for flag in flags:
            name, _, value = flag.partition(":")
            if name == "pipeline" and not value:
                kw["pipeline"] = True
            elif name == "kernel" and not value:
                kw["use_agg_kernel"] = True
            elif name == "semisync" and not value:
                kw["straggler"] = StragglerModel()
            elif name == "sparse" and value:
                kw["sparse_eval"] = float(value)
            elif name == "migrate" and value:
                kw["migrate_threshold"] = float(value)
            else:
                raise ValueError(f"{text!r}: unknown flag {flag!r}")
        return cls(engine=engine, **kw).validate()

    @classmethod
    def coerce(cls, spec: "EngineSpec | str") -> "EngineSpec":
        if isinstance(spec, str):
            return cls.parse(spec)
        if not isinstance(spec, EngineSpec):
            raise TypeError(f"spec must be an EngineSpec or preset "
                            f"string: {spec!r}")
        return spec.validate()

    @classmethod
    def from_legacy(cls, engine: str = "fused", mesh: Any = None,
                    pipeline: bool = False,
                    sparse_eval: Optional[float] = None,
                    scenario: Any = None,
                    migrate_threshold: Optional[float] = None,
                    use_agg_kernel: bool = False,
                    straggler: Any = None) -> "EngineSpec":
        """The deprecation shim's translation of the per-capability
        kwargs (including the ``engine="sharded"``/``engine="fused",
        mesh=`` double spelling)."""
        if engine == "sharded" and mesh is None:
            raise ValueError("engine='sharded' requires mesh=")
        if engine == "sharded":
            engine = "fused"
        spec = cls(
            engine=engine,
            model_shards=model_axis_size(mesh) if mesh is not None else 1,
            data_shards=data_axis_size(mesh) if mesh is not None else 1,
            pipeline=pipeline, sparse_eval=sparse_eval,
            scenario=scenario, migrate_threshold=migrate_threshold,
            use_agg_kernel=use_agg_kernel, straggler=straggler,
            mesh=mesh)
        return spec.validate()

    # -- validation --------------------------------------------------------
    def validate(self) -> "EngineSpec":
        """Every cross-field rule of the reference, checked up front, with
        its ``ValueError``, in its order. Returns self (chainable)."""
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}: "
                f"{self.engine!r}")
        if self.model_shards < 1 or self.data_shards < 1:
            raise ValueError(
                f"shard counts must be >= 1: "
                f"{self.model_shards}x{self.data_shards}")
        if self.engine != "fused":
            checks = [("mesh sharding", self.sharded),
                      ("sparse_eval", self.sparse_eval is not None),
                      ("scenario churn", self.scenario is not None),
                      ("a straggler model", self.straggler is not None)]
            if self.engine == "llm":
                checks.append(("use_agg_kernel", self.use_agg_kernel))
            else:
                checks.append(("pipeline=True", self.pipeline))
            for name, on in checks:
                if on:
                    raise ValueError(
                        f"{name} requires engine='fused', got "
                        f"{self.engine!r}")
        if self.migrate_threshold is not None and not self.sharded:
            raise ValueError(
                "migrate_threshold requires a sharded spec (mesh)")
        if self.use_agg_kernel and self.data_shards > 1:
            raise ValueError(
                "use_agg_kernel is unsupported with a sharded data axis "
                "(eq 1 completes with a psum over partial sums)")
        if self.save_every < 0:
            raise ValueError(f"save_every must be >= 0: {self.save_every}")
        if self.save_every and not self.checkpoint_dir:
            raise ValueError(
                "save_every requires checkpoint_dir (nowhere to save)")
        if self.mesh is not None:
            if (model_axis_size(self.mesh) != self.model_shards
                    or data_axis_size(self.mesh) != self.data_shards):
                raise ValueError(
                    f"mesh shape {dict(self.mesh.shape)} does not match "
                    f"spec {self.model_shards}x{self.data_shards}")
        return self

    # -- derived views -----------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.model_shards > 1 or self.data_shards > 1

    @property
    def semisync(self) -> bool:
        return self.straggler is not None

    def resolve_mesh(self, device: Any = None) -> Any:
        """The launch mesh this spec runs on (``None`` for the meshless
        engines without an injected mesh): the injected one, or a fresh
        ``make_launch_mesh(model_shards, data_shards)`` over the first
        CUDA devices (raising where there are fewer). ``device``: the
        server's requested device; a CPU request puts every cell on
        it."""
        if not self.sharded or self.mesh is not None:
            return self.mesh
        n = self.model_shards * self.data_shards
        devices = None
        if device is not None and torch.device(device).type == "cpu":
            devices = [torch.device(device)] * n
        return make_launch_mesh(self.model_shards, self.data_shards,
                                devices=devices)

    def with_mesh(self, mesh: Any) -> "EngineSpec":
        return replace(self, mesh=mesh)

    @property
    def canonical(self) -> str:
        """The preset string this spec round-trips through ``parse``
        (object-valued fields — scenario, tuned straggler models, an
        injected mesh — have no string form and are omitted)."""
        if self.sharded:
            head = f"sharded@{self.model_shards}"
            if self.data_shards > 1:
                head += f"x{self.data_shards}"
        else:
            head = self.engine
        flags = []
        if self.pipeline:
            flags.append("pipeline")
        if self.straggler is not None:
            flags.append("semisync")
        if self.sparse_eval is not None:
            flags.append(f"sparse:{self.sparse_eval:g}")
        if self.migrate_threshold is not None:
            flags.append(f"migrate:{self.migrate_threshold:g}")
        if self.use_agg_kernel:
            flags.append("kernel")
        return "+".join([head] + flags)


def resolve_spec(spec: "EngineSpec | str | None", legacy: dict,
                 owner: str) -> EngineSpec:
    """The servers' constructor entry point: coerce ``spec`` (EngineSpec
    or preset string), or translate explicitly-passed legacy kwargs
    through the deprecation shim. Passing both is an error — there would
    be two sources of truth."""
    used = {k: v for k, v in legacy.items() if v is not None}
    if spec is not None and used:
        raise TypeError(
            f"{owner}: pass either spec= or the legacy kwargs "
            f"({', '.join(sorted(used))}), not both")
    if spec is not None:
        return EngineSpec.coerce(spec)
    if used:
        warnings.warn(
            f"{owner}: the {', '.join(sorted(used))} kwargs are "
            "deprecated — pass spec=EngineSpec(...) or a preset string "
            "like 'batched' instead",
            DeprecationWarning, stacklevel=3)
    defaults = dict(engine="fused", pipeline=False,
                    use_agg_kernel=False)
    kw = {**defaults, **used}
    return EngineSpec.from_legacy(**kw)

