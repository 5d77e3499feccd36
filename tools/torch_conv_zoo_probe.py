#!/usr/bin/env python3
"""Numerical facts about the conv zoo that bound what its checks can ask,
measured on the port alone (no JAX), on the CPU by default.

    python3 tools/torch_conv_zoo_probe.py [--device cpu|cuda]

Prints one JSON line per probe:

  sensitivity — how far one f32 training step's loss, gradients (relative
      L2 over all of them, and the worst parameter) and new BN statistics
      move when the input moves by 1e-7 relative: the floor any comparison
      of two f32 implementations (card against CPU, port against the JAX
      package) meets, since their rounding differs by about that much.
      ResNet-20 (cifar10, batch 4), ResNet-50 (64×64, batch 4) and VGG-16
      (cifar10, batch 4), dropout off as in ``tests/test_torch_conv_zoo.py``,
      each also with ReLU replaced by a steep softplus
      (``relu=softplus``): if the spread falls there, the kinks of ReLU
      (pre-activations within rounding of 0 that flip) are its source.
  forward_sensitivity — the same for a train-mode forward's logits:
      ResNet-50 and SE-ResNeXt-50 (dropout off), batch 2, at 32×32 (the
      last stage is 1×1, so its BNs normalize over N·H·W = 2 values) and
      at 64×64.
  se_resnext_steps — SE-ResNeXt-50's published Momentum (lr 0.1, momentum
      0.9, L2 1e-4) for 4 steps on one repeated batch (96×96, batch 16,
      dropout off): the losses.

Weights come from ``Model.init`` with seed 0, inputs from the specs'
numpy-seeded ``synth_batch``. ``--device cuda`` runs the same on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel_all(a, b) -> float:
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return (num / den) ** 0.5


@contextlib.contextmanager
def _patched(relu: str = "relu"):
    """Dropout as the identity and, for ``relu="softplus"``, ReLU as a
    steep softplus, for the duration of the block."""
    import torch

    import paddle_tpu_torch as pt

    saved = pt.layers._ACTS["relu"], pt.layers.relu, pt.layers.dropout
    pt.layers.dropout = lambda x, *a, **k: x
    if relu == "softplus":
        smooth = lambda x: torch.nn.functional.softplus(x, beta=20.0)  # noqa: E731
        pt.layers._ACTS["relu"], pt.layers.relu = smooth, smooth
    try:
        yield
    finally:
        pt.layers._ACTS["relu"], pt.layers.relu, pt.layers.dropout = saved


def sensitivity(name, kw, batch, relu, device):
    import numpy as np
    import torch

    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.models import get_model

    with _patched(relu):
        spec = get_model(name, device=device, **kw)
        x, y = spec.synth_batch(batch, np.random.RandomState(0))
        v = spec.model.init(0, x, y, device=device)
        noise = torch.from_numpy(np.random.RandomState(1).randn(*x.shape).astype(np.float32))
        out = []
        for xs in (x, x * (1 + 1e-7 * noise.to(x.device))):
            loss, (g, new, _) = append_backward(spec.model, xs, y, state=v.state)(v.params)
            out.append((float(loss), {k: t.cpu() for k, t in g.items()},
                        {k: t.cpu() for k, t in new.items()}))
    (l0, g0, s0), (l1, g1, s1) = out
    worst = max((float((g1[k] - g0[k]).norm() / g0[k].norm()), k) for k in g0 if g0[k].norm() > 0)
    return {"probe": "sensitivity", "model": name, "cfg": kw, "batch": batch, "relu": relu,
            "input_change_rel": 1e-7, "loss_rel": abs(l1 - l0) / abs(l0),
            "grads_rel_l2": _rel_all(g1, g0), "worst_param_rel_l2": worst[0],
            "worst_param": worst[1], "bn_state_rel_l2": _rel_all(s1, s0)}


def forward_sensitivity(name, kw, device):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import get_model

    with _patched():
        spec = get_model(name, device=device, **kw)
        x, y = spec.synth_batch(2, np.random.RandomState(0))
        v = spec.model.init(0, x, y, device=device)
        noise = torch.from_numpy(np.random.RandomState(1).randn(*x.shape).astype(np.float32))
        with torch.no_grad():
            a = spec.model.apply(v, x, y, is_train=True)[0][2].double()
            b = spec.model.apply(v, x * (1 + 1e-7 * noise.to(x.device)), y, is_train=True)[0][2]
    return {"probe": "forward_sensitivity", "model": name, "cfg": kw, "batch": 2,
            "input_change_rel": 1e-7,
            "train_logits_rel_l2": float((b.double() - a).norm() / a.norm())}


def se_resnext_steps(device):
    import numpy as np

    from paddle_tpu_torch.models import get_model

    with _patched():
        spec = get_model("se_resnext", image_size=96, class_dim=102, device=device)
        x, y = spec.synth_batch(16, np.random.RandomState(4))
        v = spec.model.init(0, x, y, device=device)
        opt = spec.optimizer()
        st = opt.create_state(v.params)
        step = opt.minimize(spec.model)
        losses = []
        for _ in range(4):
            o = step(v, st, x, y)
            v, st = o.variables, o.opt_state
            losses.append(float(o.loss))
    return {"probe": "se_resnext_steps", "image_size": 96, "batch": 16, "dropout": "off",
            "optimizer": "Momentum(lr=0.1, momentum=0.9, L2Decay(1e-4))", "losses": losses}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from paddle_tpu_torch.core.config import set_flags

    set_flags(use_bf16_compute=False)
    print(json.dumps({"device": args.device, "name": torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu", "torch": torch.__version__}), flush=True)
    for name, kw, batch in (("resnet", dict(dataset="cifar10", depth=20), 4),
                            ("resnet", dict(dataset="flowers", depth=50, class_dim=1000,
                                            image_size=64), 4),
                            ("vgg", dict(dataset="cifar10"), 4)):
        for relu in ("relu", "softplus"):
            print(json.dumps(sensitivity(name, kw, batch, relu, args.device)), flush=True)
    for name, kw in (("resnet", dict(dataset="flowers", depth=50)), ("se_resnext", {})):
        for size in (32, 64):
            print(json.dumps(forward_sensitivity(name, dict(kw, image_size=size), args.device)),
                  flush=True)
    print(json.dumps(se_resnext_steps(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
