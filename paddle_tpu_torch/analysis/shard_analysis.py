"""Static sharding-layout analyzer: PartitionSpec propagation with zero
FLOPs — port of ``paddle_tpu.analysis.shard_analysis``.

Tensor-parallel replica groups (``serving.shardgroup``) are a unit of
serving dispatch, and the invariants that keep a :class:`~paddle_tpu_torch.
serving.shardgroup.GroupLayout` fast and correct would otherwise only show
once params were placed and devices burned. This pass checks them from
the program alone (the reference framework verified ``ProgramDesc`` before
execution; GSPMD/GDP argue sharding decisions should be validated and
costed statically): a param tree of shapes (an init on the ``meta``
device, :func:`eval_param_shapes`) + a rule table + a mesh *shape* (a
plain ``{axis: size}`` dict — no devices are touched) in, typed
:class:`~paddle_tpu_torch.analysis.diagnostics.Diagnostic`\\ s out.

Diagnostic codes (stable; tests match on them):

* ``shard-dead-rule`` (error) — a rule matches no parameter: stale after
  a rename, or a layout written for a different model family. Rules in
  ``GroupLayout.optional`` (e.g. the swiglu gate projections on a relu
  model) are exempt.
* ``shard-rank-mismatch`` (error) — a matched spec names more dims than
  the parameter has rank (the same condition ``spec_for(ndim=...)``
  raises at placement time, reported here as a finding so one run lists
  every offender).
* ``shard-silent-degrade`` (warning) — the axis exists but does not
  divide the dim, so ``degrade_spec`` silently replicates it; the message
  carries the per-device memory cost of the degrade. Mirrors the runtime
  ``sharding.degraded_total`` counter exactly.
* ``shard-unknown-axis`` (warning) — a spec names a mesh axis the target
  mesh does not have (a training-layout axis leaking into a serving
  mesh); placement degrades it by contract, but the rule cannot ever
  shard on this mesh.
* ``shard-conflict`` (error, :func:`compare_layouts`) — two layouts
  (e.g. training vs serving) give the same parameter different effective
  specs: every transition re-lays the weights out across the mesh.
* ``shard-kv-geometry`` (error) — the KV-page spec or shape disagrees
  with ``PagedKVCache.geometry()``: a sharded page-id/page-offset dim
  breaks the pages-are-global invariant that refcounts, the radix prefix
  cache, CoW and disagg handoff all lean on.

:func:`tp_comm_report` emits the static communication estimate for the
tp forward pass: every row-parallel boundary (Megatron column→row pair)
costs one all-reduce of the full activation row, ``2·(tp-1)/tp`` of the
payload over the wire per device for a ring.

Wired into ``DecodeEngine`` group-mode init
(:func:`lint_group_layout_or_raise` runs before any param is placed)
and into ``python -m paddle_tpu_torch.analysis`` (the ``shard`` pass).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from paddle_tpu_torch.analysis.diagnostics import ERROR, WARNING, Diagnostic
from paddle_tpu_torch.parallel.sharding import (
    MISSING_AXIS,
    NON_DIVISIBLE,
    P,
    ShardingRules,
    degraded_dims,
    mesh_axis_sizes,
)

__all__ = [
    "CommBoundary",
    "CommReport",
    "analyze_layout",
    "analyze_model",
    "compare_layouts",
    "eval_param_shapes",
    "lint_group_layout_or_raise",
    "tp_comm_report",
]

# KV page arrays are [L, num_pages, H_kv, page_size, dh]; page ids are
# global across a replica group, so only the head dim may shard
KV_PAGES_DIM = 1
KV_HEAD_DIM = 2
KV_OFFSET_DIM = 3

AxisSizes = Mapping[str, int]
# a layout: a GroupLayout-like object (``.rules`` + ``.optional``) or a
# bare rule table
LayoutLike = Union[ShardingRules, Any]


def _shape_of(v: Any) -> Tuple[int, ...]:
    """Accept tensors (``meta`` ones included), arrays, or plain shape
    tuples."""
    shape = getattr(v, "shape", v)
    return tuple(int(s) for s in shape)


def _dtype_bytes(v: Any, default: int = 4) -> int:
    dtype = getattr(v, "dtype", None)
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return default


def _rules_of(layout: LayoutLike) -> Tuple[ShardingRules, Tuple[str, ...]]:
    rules = getattr(layout, "rules", layout)
    optional = tuple(getattr(layout, "optional", ()))
    return tuple(rules), optional


def _first_match(name: str, rules: ShardingRules):
    for idx, (pattern, spec) in enumerate(rules):
        if fnmatch.fnmatchcase(name, pattern):
            return idx, pattern, spec
    return None


def _spec_dims(spec, rank: int) -> Tuple[Optional[str], ...]:
    dims = tuple(spec) + (None,) * max(0, rank - len(spec))
    return dims[:rank]


def _effective_spec(
    name: str, shape: Tuple[int, ...], layout: LayoutLike, axis_sizes: AxisSizes
) -> Tuple[Optional[str], ...]:
    """The spec a param actually gets: first-match rule, padded to rank,
    degraded exactly as ``degrade_spec`` would. Replicated on no match."""
    rules, _ = _rules_of(layout)
    hit = _first_match(name, rules)
    if hit is None:
        return (None,) * len(shape)
    _, _, spec = hit
    dims = list(_spec_dims(spec, len(shape)))
    for i, _axis, _reason in degraded_dims(axis_sizes, spec, shape):
        if i < len(dims):
            dims[i] = None
    return tuple(dims)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"


def _degrade_cost_bytes(
    shape: Tuple[int, ...], spec, axis_sizes: AxisSizes, dim: int, dtype_bytes: int
) -> int:
    """Extra per-device HBM of replicating ``dim`` instead of sharding it:
    the param's actual per-device bytes (after every degrade) minus what
    they would be had this one dim sharded as asked."""
    total = int(np.prod(shape)) * dtype_bytes if shape else dtype_bytes
    dims = _spec_dims(spec, len(shape))
    dropped = {i for i, _, _ in degraded_dims(axis_sizes, spec, shape)}
    shard_factor = 1
    for i, axis in enumerate(dims):
        if axis is not None and i not in dropped:
            shard_factor *= axis_sizes.get(axis, 1)
    actual = total // max(1, shard_factor)
    n = axis_sizes.get(dims[dim], 1)
    return actual - actual // max(1, n)


# ---------------------------------------------------------------------------
# core pass: one layout over one param tree
# ---------------------------------------------------------------------------


def analyze_layout(
    params: Mapping[str, Any],
    layout: LayoutLike,
    axis_sizes: AxisSizes,
    *,
    kv_page_shape: Optional[Tuple[int, ...]] = None,
    kv_geometry: Optional[Mapping[str, int]] = None,
    where: str = "layout",
) -> List[Diagnostic]:
    """Propagate the layout's PartitionSpecs over a param tree without
    touching devices and report every invariant violation as a
    :class:`Diagnostic`. ``params`` maps name → shape-like (eval_shape
    structs, arrays, or plain tuples); ``axis_sizes`` is the mesh shape
    (``{"tp": 4}``)."""
    rules, optional = _rules_of(layout)
    diags: List[Diagnostic] = []
    matched: set = set()
    for name in sorted(params):
        shape = _shape_of(params[name])
        dtype_bytes = _dtype_bytes(params[name])
        hit = _first_match(name, rules)
        if hit is None:
            continue
        idx, pattern, spec = hit
        matched.add(idx)
        if len(spec) > len(shape):
            diags.append(Diagnostic(
                "shard-rank-mismatch",
                f"rule {pattern!r} names {len(spec)} dims but param {name!r} "
                f"has rank {len(shape)} {shape} — a layout written for a "
                "different parameter shape (placement would raise here)",
                where=name,
            ))
            continue
        for dim, axis, reason in degraded_dims(axis_sizes, spec, shape):
            if reason == MISSING_AXIS:
                diags.append(Diagnostic(
                    "shard-unknown-axis",
                    f"rule {pattern!r} shards dim {dim} of {name!r} over "
                    f"axis {axis!r}, which this mesh "
                    f"({dict(axis_sizes)}) does not have — the rule can "
                    "never shard here and degrades to replicated",
                    severity=WARNING, where=name,
                ))
            else:  # NON_DIVISIBLE: the silent degrade, costed in HBM
                n = axis_sizes[axis]
                cost = _degrade_cost_bytes(shape, spec, axis_sizes, dim,
                                           dtype_bytes)
                diags.append(Diagnostic(
                    "shard-silent-degrade",
                    f"dim {dim} (size {shape[dim]}) of {name!r} is not "
                    f"divisible by mesh axis {axis!r} (size {n}); "
                    "degrade_spec silently replicates it, costing "
                    f"{_fmt_bytes(cost)} extra HBM per device",
                    severity=WARNING, where=name,
                ))
    for idx, (pattern, spec) in enumerate(rules):
        if idx in matched or pattern in optional:
            continue
        diags.append(Diagnostic(
            "shard-dead-rule",
            f"rule {pattern!r} -> {spec} matches no parameter — stale "
            "after a rename, or a layout for a different model family "
            "(mark variant-only families in GroupLayout.optional)",
            where=f"{where}:rule[{idx}]",
        ))
    if kv_page_shape is not None:
        diags.extend(_analyze_kv_pages(layout, kv_page_shape, kv_geometry,
                                       axis_sizes))
    return diags


def _kv_spec_dims(layout: LayoutLike, rank: int) -> Tuple[Optional[str], ...]:
    kv_rule = getattr(layout, "kv_rule", None)
    if kv_rule is not None:
        return _spec_dims(kv_rule, rank)
    tp_axis = getattr(layout, "tp_axis", "tp")
    dims = [None] * rank
    if rank > KV_HEAD_DIM:
        dims[KV_HEAD_DIM] = tp_axis
    return tuple(dims)


def _analyze_kv_pages(
    layout: LayoutLike,
    shape: Tuple[int, ...],
    geometry: Optional[Mapping[str, int]],
    axis_sizes: AxisSizes,
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    dims = _kv_spec_dims(layout, len(shape))
    if geometry:
        for dim, key in ((KV_PAGES_DIM, "num_pages"),
                         (KV_OFFSET_DIM, "page_size")):
            want = geometry.get(key)
            if want is not None and len(shape) > dim and shape[dim] != want:
                diags.append(Diagnostic(
                    "shard-kv-geometry",
                    f"KV page array dim {dim} is {shape[dim]} but "
                    f"PagedKVCache.geometry()[{key!r}] is {want} — the page "
                    "tables would index pages that do not exist",
                    where="kv_pages",
                ))
    for dim in (KV_PAGES_DIM, KV_OFFSET_DIM):
        if len(dims) > dim and dims[dim] is not None:
            diags.append(Diagnostic(
                "shard-kv-geometry",
                f"KV page spec shards dim {dim} "
                f"({'page ids' if dim == KV_PAGES_DIM else 'page offsets'}) "
                f"over axis {dims[dim]!r}: page ids are global across a "
                "replica group — sharding them breaks refcounts, the radix "
                "prefix cache, CoW and disagg handoff; only the head dim "
                f"({KV_HEAD_DIM}) may shard",
                where="kv_pages",
            ))
    for dim, axis, reason in degraded_dims(axis_sizes, P(*dims), shape):
        if reason == NON_DIVISIBLE and dim == KV_HEAD_DIM:
            diags.append(Diagnostic(
                "shard-silent-degrade",
                f"KV head count {shape[dim]} is not divisible by axis "
                f"{axis!r} (size {axis_sizes[axis]}); the whole page cache "
                "replicates per device — the tp memory win is silently lost",
                severity=WARNING, where="kv_pages",
            ))
    return diags


# ---------------------------------------------------------------------------
# cross-layout conflicts (training vs serving, tp=2 vs tp=4 rule tables, ...)
# ---------------------------------------------------------------------------


def compare_layouts(
    layouts: Mapping[str, LayoutLike],
    params: Mapping[str, Any],
    axis_sizes: AxisSizes,
) -> List[Diagnostic]:
    """Effective-spec conflicts for the same param across named layouts.
    Any difference means every transition between the two contexts (e.g.
    checkpoint restore from training into serving) re-lays the parameter
    out across the mesh — legitimate sometimes, but never silently."""
    diags: List[Diagnostic] = []
    for name in sorted(params):
        shape = _shape_of(params[name])
        effective = {
            label: _effective_spec(name, shape, layout, axis_sizes)
            for label, layout in layouts.items()
        }
        if len(set(effective.values())) > 1:
            detail = ", ".join(
                f"{label}={spec}" for label, spec in sorted(effective.items()))
            diags.append(Diagnostic(
                "shard-conflict",
                f"param {name!r} gets conflicting effective specs across "
                f"layouts: {detail} — every transition between them is a "
                "full cross-mesh resharding of this parameter",
                where=name,
            ))
    return diags


# ---------------------------------------------------------------------------
# static communication estimate for the tp forward pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommBoundary:
    """One column→row boundary: the all-reduce after a row-parallel
    matmul. ``payload_bytes`` is the full activation row per token;
    ``wire_bytes`` the per-device ring traffic (``2·(tp-1)/tp`` of it)."""

    param: str
    out_features: int
    payload_bytes: int
    wire_bytes: int


@dataclasses.dataclass(frozen=True)
class CommReport:
    """Per-token communication of one tp forward pass, statically derived
    from the rule table: every effective row-parallel 2-d weight is one
    all-reduce boundary."""

    tp_axis: str
    tp: int
    dtype_bytes: int
    boundaries: Tuple[CommBoundary, ...]

    @property
    def total_payload_bytes(self) -> int:
        return sum(b.payload_bytes for b in self.boundaries)

    @property
    def total_wire_bytes(self) -> int:
        return sum(b.wire_bytes for b in self.boundaries)

    def format(self) -> str:
        lines = [
            f"tp comm report: axis {self.tp_axis!r} degree {self.tp}, "
            f"{self.dtype_bytes}B/elem, per token:",
            f"  {'boundary (row-parallel weight)':<44}"
            f"{'payload':>10}{'wire/device':>14}",
        ]
        for b in self.boundaries:
            lines.append(
                f"  {b.param:<44}{_fmt_bytes(b.payload_bytes):>10}"
                f"{_fmt_bytes(b.wire_bytes):>14}")
        lines.append(
            f"  total: {len(self.boundaries)} all-reduce(s), "
            f"{_fmt_bytes(self.total_payload_bytes)} payload, "
            f"{_fmt_bytes(self.total_wire_bytes)} wire/device")
        return "\n".join(lines)


def tp_comm_report(
    params: Mapping[str, Any],
    layout: LayoutLike,
    axis_sizes: AxisSizes,
    *,
    dtype_bytes: int = 4,
) -> CommReport:
    """Estimate the forward-pass all-reduce traffic a layout implies.
    Column-parallel matmuls keep their outputs sharded (no comm); each
    row-parallel weight ``[in, out]`` with the tp axis on dim 0 ends a
    Megatron pair and all-reduces its ``[*, out]`` activation."""
    tp_axis = getattr(layout, "tp_axis", "tp")
    tp = int(axis_sizes.get(tp_axis, 1))
    boundaries: List[CommBoundary] = []
    for name in sorted(params):
        shape = _shape_of(params[name])
        if len(shape) != 2:
            continue
        spec = _effective_spec(name, shape, layout, axis_sizes)
        if spec[0] == tp_axis:
            payload = shape[1] * dtype_bytes
            wire = int(payload * 2 * (tp - 1) / tp) if tp > 1 else 0
            boundaries.append(CommBoundary(name, shape[1], payload, wire))
    return CommReport(tp_axis, tp, dtype_bytes, tuple(boundaries))


# ---------------------------------------------------------------------------
# conveniences: eval_shape param trees, whole-model analysis, engine hook
# ---------------------------------------------------------------------------


def eval_param_shapes(model: str = "transformer_lm", **cfg):
    """``(param_shapes, model_cfg)`` for a registered model via its
    ``init`` on the ``meta`` device — zero FLOPs, zero device memory,
    exact names/shapes/dtypes (the JAX package's ``jax.eval_shape``)."""
    from paddle_tpu_torch import models

    spec = models.get_model(model, device="meta", **cfg)
    rng = np.random.RandomState(0)
    batch = spec.synth_batch(1, rng)
    shapes = spec.model.init(0, *batch, device="meta").params
    return shapes, dict(spec.extra.get("cfg", {}))


def analyze_model(
    model: str = "transformer_lm",
    *,
    tp: int = 1,
    layout: Optional[LayoutLike] = None,
    page_size: int = 16,
    num_pages: int = 64,
    **cfg,
) -> Tuple[List[Diagnostic], CommReport]:
    """One-call analysis of a registered model under a layout at a given
    tp degree, KV-page checks included (what the JAX package's CLI
    ``shard`` pass runs)."""
    if layout is None:
        from paddle_tpu_torch.serving.shardgroup import default_layout

        layout = default_layout()
    shapes, model_cfg = eval_param_shapes(model, **cfg)
    axis_sizes = {getattr(layout, "tp_axis", "tp"): int(tp)}
    kv_shape = None
    kv_geometry = None
    if model == "transformer_lm":
        from paddle_tpu_torch.models.transformer_lm import paged_cache_shape

        kv_shape = tuple(paged_cache_shape(model_cfg, num_pages, page_size))
        kv_geometry = {"num_pages": num_pages, "page_size": page_size}
    diags = analyze_layout(
        shapes, layout, axis_sizes, kv_page_shape=kv_shape,
        kv_geometry=kv_geometry, where=f"{model}@tp={tp}")
    report = tp_comm_report(shapes, layout, axis_sizes)
    return diags, report


def lint_group_layout_or_raise(
    params: Mapping[str, Any],
    layout: LayoutLike,
    mesh,
    *,
    kv_page_shape: Optional[Tuple[int, ...]] = None,
    kv_geometry: Optional[Mapping[str, int]] = None,
    where: str = "group layout",
) -> List[Diagnostic]:
    """The serving init hook: analyze a layout against the actual params
    about to be placed on a replica group's mesh. Error findings raise
    ``EnforceError`` BEFORE any block is copied to a member on a bad layout;
    warnings are logged once each. Returns every diagnostic."""
    from paddle_tpu_torch.core import logging as ptlog
    from paddle_tpu_torch.core.enforce import enforce

    diags = analyze_layout(
        params, layout, mesh_axis_sizes(mesh),
        kv_page_shape=kv_page_shape, kv_geometry=kv_geometry, where=where)
    errors = [d for d in diags if d.severity == ERROR]
    for d in diags:
        if d.severity != ERROR:
            ptlog.warn_once(("shard-analysis", where, d.code, d.where),
                            "shard analysis [%s]: %s", d.code, str(d))
    enforce(
        not errors,
        f"{where}: static shard analysis found {len(errors)} error(s) — "
        "refusing to place params on the group:\n"
        + "\n".join(str(d) for d in errors),
    )
    return diags
