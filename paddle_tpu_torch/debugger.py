"""Program observability: program dumps, graph drawing, memory stats, NaN
guard — port of ``paddle_tpu/debugger.py``.

Reference: ``python/paddle/fluid/debugger.py:275`` (draw_block_graphviz),
``framework/ir/graph_viz_pass.cc:138`` (DOT dumps of the op graph), and
the numeric sanitizer flag FLAGS_check_nan_inf (``operator.cc:725-737``).

The JAX package inspects the traced jaxpr and its lowered StableHLO; the
port's program is the graph ``torch.export`` traces (ATen operators; the
flash forward as ``paddle_tpu_torch::flash_fwd``). There is no XLA, so no
backend-optimized dump. Memory observability comes from the CUDA caching
allocator's statistics (the analogue of FLAGS_benchmark memory logs,
``executor.cc:399-401``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import torch

__all__ = [
    "program_to_text",
    "program_to_hlo",
    "draw_graph",
    "memory_summary",
    "nan_guard",
]


def _export(fn_or_model, example_args):
    """``torch.export`` of the function (or a Model's eval-mode apply, whose
    first argument is its variables) at ``example_args``."""
    from paddle_tpu_torch.framework import Model, Variables
    from paddle_tpu_torch.io import FunctionModule

    fn = fn_or_model
    if isinstance(fn_or_model, Model):
        model = fn_or_model

        def fn(variables, *args):
            return model.apply(variables, *args, is_train=False)

    # Variables go in as a plain (params, state) pair, which apply accepts
    args = tuple(tuple(a) if isinstance(a, Variables) else a for a in example_args)
    with torch.no_grad():
        return torch.export.export(FunctionModule(fn), args)


def program_to_text(fn_or_model, *example_args) -> str:
    """The traced program's graph, one ATen operator a line (the
    ProgramDesc text dump analogue)."""
    return str(_export(fn_or_model, example_args).graph)


def program_to_hlo(fn_or_model, *example_args, optimized: bool = False) -> str:
    """The exported program's Python code (the JAX package returns
    StableHLO). ``optimized=True`` (XLA's optimized HLO) raises: there is
    no XLA in the port."""
    if optimized:
        raise NotImplementedError(
            "program_to_hlo(optimized=True): no XLA in the port, so no backend-optimized "
            "program (ROADMAP.md §A item 3: not applicable); call with optimized=False for "
            "the exported graph's code")
    return _export(fn_or_model, example_args).graph_module.code


def draw_graph(fn_or_model, *example_args, path: Optional[str] = None) -> str:
    """DOT graph of the traced program (draw_block_graphviz /graph_viz_pass
    parity): one node per operator, edges along def-use."""
    graph = _export(fn_or_model, example_args).graph
    lines = ["digraph program {", "  rankdir=TB;", "  node [shape=box, fontsize=10];"]
    ids = {}
    n_in = n_op = 0
    for node in graph.nodes:
        if node.op == "placeholder":
            ids[node] = f"in{n_in}"
            val = node.meta.get("val")
            desc = (f"{str(val.dtype).replace('torch.', '')}{list(val.shape)}"
                    if isinstance(val, torch.Tensor) else node.name)
            lines.append(f'  in{n_in} [label="input {desc}", shape=ellipse];')
            n_in += 1
        elif node.op == "output":
            for i, src in enumerate(n for n in node.all_input_nodes if n in ids):
                lines.append(f'  out{i} [label="output", shape=ellipse];')
                lines.append(f"  {ids[src]} -> out{i};")
        else:
            ids[node] = f"op{n_op}"
            label = getattr(node.target, "__name__", str(node.target))
            lines.append(f'  op{n_op} [label="{label}"];')
            for src in node.all_input_nodes:
                if src in ids:
                    lines.append(f"  {ids[src]} -> op{n_op};")
            n_op += 1
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def memory_summary(device: Any = None) -> dict:
    """Device allocator stats — the memory_usage logging of FLAGS_benchmark:
    ``torch.cuda.memory_stats`` plus the JAX package's key names
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``). ``device``
    defaults to the card. On the CPU (``device="cpu"``), which exposes no
    stats, ``{}`` as the JAX package gives for such a device."""
    from paddle_tpu_torch.core.config import resolve_device

    dev = resolve_device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats.update(
        bytes_in_use=stats.get("allocated_bytes.all.current", 0),
        peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
        bytes_limit=torch.cuda.get_device_properties(dev).total_memory,
    )
    return stats


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """NaN/Inf detection within the context (FLAGS_check_nan_inf parity):
    turns on the ``check_nan_inf`` flag — fetched outputs
    (``Executor.run(fetch=True)``) and the optimizer's and the Trainer's
    steps raise on a non-finite value — and restores it after."""
    from paddle_tpu_torch.core.config import flags, set_flags

    prev = flags().check_nan_inf
    set_flags(check_nan_inf=True)
    try:
        yield
    finally:
        set_flags(check_nan_inf=prev)
