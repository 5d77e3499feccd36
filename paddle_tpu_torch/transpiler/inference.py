"""Inference-time optimization: BN folding and eval-mode prediction, port
of ``paddle_tpu/transpiler/inference.py``.

Reference: ``python/paddle/fluid/transpiler/inference_transpiler.py`` —
fuse batch_norm into the preceding conv/fc (its ``_fuse_bn`` rewrites the
program and adjusts weights). Here, as in the JAX package, only the WEIGHT
transform is done: BN's (scale, bias, moving_mean, moving_var) fold into
the adjacent conv kernel and bias, and BN becomes the identity; dropout
stripping is ``is_train=False``.

Layouts: the port stores conv weights under the JAX package's names and
shapes (HWIO, ``[kh, kw, c_in, c_out]``); ``ops/nn.py::conv2d`` runs cuDNN
on channels-last views of them. The fold scales the stored weight along
its last (output-channel) axis, so the folded weights are the JAX
package's element for element.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch

from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.framework import Model, Variables

__all__ = ["fuse_batch_norm", "find_conv_bn_pairs", "inference_optimize"]


def find_conv_bn_pairs(variables: Variables) -> List[Tuple[str, str]]:
    """Detect (conv_scope, bn_scope) pairs by the layer naming convention:
    a ``.../conv2d*/w`` parameter whose sibling scope ``.../batch_norm*``
    holds scale/bias params and moving stats, with matching channel count.
    Mirrors the pattern matching of ``inference_transpiler.py`` _fuse_bn
    (there done on the op graph; here on the name hierarchy)."""
    params, state = variables.params, variables.state
    conv_scopes = {}
    for name in params:
        m = re.match(r"^(.*conv2d[^/]*)/w$", name)
        if m:
            conv_scopes[m.group(1)] = params[name]
    bn_scopes = set()
    for name in state:
        m = re.match(r"^(.*batch_norm[^/]*)/moving_mean$", name)
        if m:
            bn_scopes.add(m.group(1))

    pairs = []
    for conv_scope, w in conv_scopes.items():
        # sibling bn scope: same parent, batch_norm block created right after
        parent = conv_scope.rsplit("/", 1)[0] if "/" in conv_scope else ""
        suffix = re.search(r"_(\d+)$", conv_scope.rsplit("/", 1)[-1])
        candidates = [
            b
            for b in bn_scopes
            if (b.rsplit("/", 1)[0] if "/" in b else "") == parent
        ]
        if suffix:
            candidates = [b for b in candidates if b.endswith(f"_{suffix.group(1)}")]
        else:
            candidates = [b for b in candidates if not re.search(r"_\d+$", b)]
        for b in candidates:
            if state[f"{b}/moving_mean"].shape[0] == w.shape[-1]:
                pairs.append((conv_scope, b))
    return pairs


def fuse_batch_norm(
    variables: Variables,
    pairs: Optional[List[Tuple[str, str]]] = None,
    epsilon: float = 1e-5,
) -> Variables:
    """Fold BN into conv weights: ``w' = w * gamma/sqrt(var+eps)`` per output
    channel, ``b' = beta - gamma*mean/sqrt(var+eps)`` (+ folded old bias).
    BN scale/bias become identity (1, 0) so the SAME program computes the
    fused result. Returns new dicts; the given tensors are not changed."""
    params = dict(variables.params)
    state = dict(variables.state)
    pairs = pairs if pairs is not None else find_conv_bn_pairs(variables)
    for conv_scope, bn_scope in pairs:
        w_name = f"{conv_scope}/w"
        gamma = params[f"{bn_scope}/scale"]
        beta = params[f"{bn_scope}/bias"]
        mean = state[f"{bn_scope}/moving_mean"]
        var = state[f"{bn_scope}/moving_variance"]
        inv_std = 1.0 / torch.sqrt(var + epsilon)
        factor = gamma * inv_std  # [C_out]
        params[w_name] = params[w_name] * factor  # HWIO: broadcast over C_out
        b_name = f"{conv_scope}/b"
        old_b = params.get(b_name, torch.zeros_like(beta))
        fused_b = (old_b - mean) * factor + beta
        # the fused bias lands in the conv bias if one exists, else in the
        # (now otherwise-identity) BN bias; BN becomes a no-op either way
        if b_name in params:
            params[b_name] = fused_b
            params[f"{bn_scope}/bias"] = torch.zeros_like(beta)
        else:
            params[f"{bn_scope}/bias"] = fused_b
        params[f"{bn_scope}/scale"] = torch.ones_like(gamma)
        state[f"{bn_scope}/moving_mean"] = torch.zeros_like(mean)
        # var + epsilon must equal exactly 1 so the residual 1/sqrt is identity
        state[f"{bn_scope}/moving_variance"] = torch.full_like(var, 1.0 - epsilon)
    ptlog.vlog(1, "fuse_batch_norm folded %d conv+bn pairs", len(pairs))
    return Variables(params=params, state=state)


def inference_optimize(
    model: Model,
    variables: Variables,
    fuse_bn: bool = True,
    epsilon: float = 1e-5,
):
    """Produce (predict_fn, optimized_variables) for deployment: eval mode
    (dropout stripped, BN uses moving stats), BN folded into conv weights.
    ``predict_fn(variables, *batch)`` runs under ``torch.no_grad``."""
    with torch.no_grad():
        opt_vars = fuse_batch_norm(variables, epsilon=epsilon) if fuse_bn else variables

    def predict_fn(params_state: Variables, *batch):
        with torch.no_grad():
            out, _ = model.apply(params_state, *batch, is_train=False)
        return out

    return predict_fn, opt_vars
