"""Tensor-parallel replica groups — port of ``paddle_tpu.serving.shardgroup``.

The unit of serving dispatch becomes a **replica group**: an ordered
tuple of member devices that together run ONE decode engine's steps,
each member holding a block of the parameters and of the paged KV cache,
instead of one whole-model replica per device. The reference stack's
analogue was ParallelExecutor's per-GPU SSA graph + NCCL allreduce rings
(``multi_devices_graph_pass.cc:286``). The group's layout is declarative
— a :class:`GroupLayout` rule table maps every ``transformer_lm``
parameter name to a ``PartitionSpec`` over the group's ``tp`` mesh.

**One process drives the whole group.** The JAX package's group is a
single-controller program over several devices, and one process holds
several group engines (``DecodeFleet.from_groups``). The port keeps that
shape: the members are ``torch.device``\\ s that this process drives, and
the engine's scheduler, page allocator, prefix cache, journal, breaker
and fleet stay single, exactly as in the JAX package. The ``tp``
collective that GSPMD inserts into the JAX step is explicit code in the
port's step (``models.transformer_lm.GroupPagedDecoder``): each
row-parallel partial (the attention out-projection, FFN fc2) is brought
to member 0's device, the partials are summed in member order, the bias
is added once, and the sum is copied to every member, so the replicated
activations are bit-equal on every member. On one card those copies stay
on the device; on several cards they are peer copies. A group of
several processes with a ``tp`` process group was not taken: every step
would broadcast the scheduler's batch to every member, and on one card
its exchanges would be host-staged gloo copies. Members may repeat a
device (four members on ``cuda:0``): that is how one card runs groups,
and how the CPU tests run them on ``cpu``.

Layout (Megatron-style, heads over ``tp``):

- q/k/v projections column-parallel ``P(None, "tp")`` (their biases
  ``P("tp")``), attention out row-parallel ``P("tp", None)``;
- ffn fc1/gate column-parallel, fc2 row-parallel;
- embeddings, logits projection and layernorms replicated (tiny, and the
  test vocab is deliberately not divisible by tp);
- paged KV arrays ``[L, num_pages, H_kv, page_size, dh]`` sharded on the
  head dim ``P(None, None, "tp", None, None)``.

Every member's page geometry is identical — page ids are global and only
heads are split — so refcounts, the radix prefix cache, CoW and trim are
unchanged. Any dim whose size doesn't divide the tp degree degrades to
replicated (the contract of ``parallel.sharding.degrade_spec``), so one
model definition runs at any tp that divides its head counts and falls
back otherwise.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.parallel.mesh import TP_AXIS, Mesh, partition_devices, tp_submesh
from paddle_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    ShardingRules,
    degrade_spec,
    spec_for,
)
from paddle_tpu_torch.resilience import faults

__all__ = [
    "GroupLayout",
    "GroupStragglerWatch",
    "ReplicaGroup",
    "default_layout",
    "make_groups",
    "probe_members",
]

# Head dim of the paged KV arrays [L, num_pages, H_kv, page_size, dh]
KV_HEAD_DIM = 2


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """An ordered member-device tuple + its ``tp`` mesh: the unit of
    dispatch.

    Device order is part of the identity — block i of every parameter and
    KV page lives on ``devices[i]``, and the straggler watch reports skew
    by that index."""

    devices: Tuple[torch.device, ...]
    name: str = ""

    def __post_init__(self):
        enforce(len(self.devices) >= 1, "ReplicaGroup needs >= 1 device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if not self.name:
            object.__setattr__(
                self, "name", "group[" + ",".join(str(d) for d in self.devices) + "]"
            )
        object.__setattr__(self, "_mesh", tp_submesh(self.devices))

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def tp(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_groups(tp: int, devices: Optional[Sequence] = None) -> List[ReplicaGroup]:
    """Slice the device list into contiguous replica groups of ``tp``.
    ``devices`` defaults to every visible card; without them (too few
    cards, or none) this raises — pass ``devices=`` to run groups
    elsewhere (``[torch.device("cpu")] * 4``)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        enforce(n >= tp,
                f"make_groups: tp={tp} needs {tp} CUDA devices but {n} are visible "
                "(pass devices= to build groups on other devices)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return [
        ReplicaGroup(devs, name=f"group{i}")
        for i, devs in enumerate(partition_devices(tp, devices))
    ]


# Megatron-style rule table for transformer_lm param names. First match
# wins; anything unmatched is replicated (embeddings, logits, layernorms,
# out/fc2 biases — the row-parallel outputs are full-size after the psum).
_TRANSFORMER_LM_RULES: ShardingRules = (
    ("*/self_attn/q/w", P(None, TP_AXIS)),
    ("*/self_attn/k/w", P(None, TP_AXIS)),
    ("*/self_attn/v/w", P(None, TP_AXIS)),
    ("*/self_attn/q/b", P(TP_AXIS)),
    ("*/self_attn/k/b", P(TP_AXIS)),
    ("*/self_attn/v/b", P(TP_AXIS)),
    ("*/self_attn/out/w", P(TP_AXIS, None)),
    ("*/ffn/fc1/w", P(None, TP_AXIS)),
    ("*/ffn/gate/w", P(None, TP_AXIS)),
    ("*/ffn/fc1/b", P(TP_AXIS)),
    ("*/ffn/gate/b", P(TP_AXIS)),
    ("*/ffn/fc2/w", P(TP_AXIS, None)),
)


def member_block(t: torch.Tensor, spec: P, mesh: Mesh, member: int) -> torch.Tensor:
    """Member ``member``'s block of the whole tensor ``t`` under a
    (degraded) ``spec``: each dim named with an axis of size n cut n ways."""
    for dim, axis in enumerate(spec):
        n = mesh.shape.get(axis, 1) if axis is not None else 1
        if n > 1:
            k = t.shape[dim] // n
            t = t.narrow(dim, member * k, k)
    return t


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """PartitionSpecs per param class over a replica group's mesh (the
    SpecLayout pattern: named axes + a spec per parameter family, except
    driven by a first-match rule table over param NAMES so the serving
    path needs no model-code cooperation).

    ``optional`` lists rule patterns allowed to match no parameter — the
    swiglu gate projections exist only in that FFN variant, so their
    rules are not dead on a relu model. Any other zero-match rule is a
    ``shard-dead-rule`` finding in ``analysis.shard_analysis`` (stale
    after a param rename, or a layout for the wrong model family).
    ``kv_rule`` overrides the default head-dim KV-page spec; the static
    analyzer checks it against ``PagedKVCache.geometry()`` — page-id and
    page-offset dims must stay global across the group."""

    tp_axis: str = TP_AXIS
    rules: ShardingRules = _TRANSFORMER_LM_RULES
    optional: Tuple[str, ...] = ("*/ffn/gate/w", "*/ffn/gate/b")
    kv_rule: Optional[P] = None

    def param_spec(self, name: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
        spec = spec_for(name, self.rules, ndim=len(shape))
        return degrade_spec(mesh, spec, shape, name=name)

    def param_sharding(
        self, group: ReplicaGroup, name: str, shape: Tuple[int, ...]
    ) -> NamedSharding:
        return NamedSharding(group.mesh, self.param_spec(name, shape, group.mesh))

    def kv_page_spec(self, shape: Tuple[int, ...], mesh: Mesh) -> P:
        """KV pages sharded along heads; degrades to replicated when the
        kv-head count doesn't divide tp (the same model still serves, just
        without the memory win)."""
        if self.kv_rule is not None:
            return degrade_spec(mesh, self.kv_rule, shape, name="kv_pages")
        dims = [None] * len(shape)
        if len(shape) > KV_HEAD_DIM:
            dims[KV_HEAD_DIM] = self.tp_axis
        return degrade_spec(mesh, P(*dims), shape, name="kv_pages")

    def kv_page_sharding(
        self, group: ReplicaGroup, shape: Tuple[int, ...]
    ) -> NamedSharding:
        return NamedSharding(group.mesh, self.kv_page_spec(shape, group.mesh))

    def replicated(self, group: ReplicaGroup) -> NamedSharding:
        return NamedSharding(group.mesh, P())

    def shard_params(
        self, group: ReplicaGroup, params: Dict[str, torch.Tensor]
    ) -> List[Dict[str, torch.Tensor]]:
        """Place every param on the group under its rule — the group-mode
        analogue of ``parallel.sharding.shard_variables``: one dict per
        member, holding its block of each parameter (cut by the degraded
        spec) on its device. A replicated parameter is the whole tensor on
        every member. Every member gets its own copy, also of a parameter
        that is already on its device, as each would on a card of its own."""
        out: List[Dict[str, torch.Tensor]] = [{} for _ in group.devices]
        for name, v in params.items():
            spec = self.param_spec(name, tuple(v.shape), group.mesh)
            for m, dev in enumerate(group.devices):
                blk = member_block(v, spec, group.mesh, m)
                out[m][name] = torch.empty(blk.shape, dtype=v.dtype, device=dev).copy_(blk)
        return out


def default_layout() -> GroupLayout:
    return GroupLayout()


def probe_members(
    group: ReplicaGroup, *, engine_label: Optional[str] = None, nbytes: int = 1 << 12
) -> Dict[int, float]:
    """Per-member liveness/latency canary: time a small host→device copy
    to EACH member individually, synchronized (a fault or a stall inside
    the group's step cannot be attributed to one member; this can). The
    ``GROUP_MEMBER`` fault point fires per shard so chaos can fail or
    stall exactly one member. Raises whatever the injected fault raises —
    the engine treats any member fault as fatal for the whole group."""
    payload = torch.from_numpy(np.zeros(nbytes, np.uint8))
    times: Dict[int, float] = {}
    for i, dev in enumerate(group.devices):
        t0 = time.perf_counter()
        faults.inject(
            faults.GROUP_MEMBER, engine=engine_label, shard=i, device=str(dev)
        )
        payload.to(dev, copy=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[i] = time.perf_counter() - t0
    return times


class GroupStragglerWatch:
    """Localize the slow member INSIDE a group from per-shard probe timings.

    Same windowed spatial-median core as the watch layer's
    ``SkewDetector``, with one change a tiny group forces: the baseline
    for shard i is the median of the OTHER shards' recent means
    (leave-one-out). A median over ALL keys is right for a fleet of
    replicas but breaks at tp=2 — the 2-element median averages the
    straggler in, bounding the ratio below 2.0 so no sane threshold can
    ever fire. ``observe`` returns ``(worst_skew, flagged_shard)``; skew
    1.0 means perfectly balanced."""

    def __init__(self, group: ReplicaGroup, *, ratio: float = 4.0,
                 window: int = 32, min_samples: int = 5):
        enforce(ratio > 1.0, f"skew ratio must be > 1.0, got {ratio}")
        enforce(min_samples >= 2,
                f"min_samples must be >= 2, got {min_samples}")
        self._group = group
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self._series: Dict[int, deque] = {
            i: deque(maxlen=window) for i in range(len(group.devices))
        }

    def observe(self, shard_times: Dict[int, float]) -> Tuple[float, Optional[int]]:
        for shard, seconds in shard_times.items():
            if shard in self._series and seconds >= 0:
                self._series[shard].append(float(seconds))
        ready = {i: s for i, s in self._series.items()
                 if len(s) >= self.min_samples}
        if len(ready) < 2:
            return 1.0, None
        means = {i: sum(s) / len(s) for i, s in ready.items()}
        flagged: Optional[int] = None
        worst = 1.0
        for shard in sorted(means):
            peers = [m for i, m in means.items() if i != shard]
            baseline = statistics.median(peers)
            if baseline <= 0:
                continue
            skew = means[shard] / baseline
            if skew > worst:
                worst = skew
                if skew > self.ratio:
                    flagged = shard
        return worst, flagged
