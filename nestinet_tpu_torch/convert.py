"""Weight conversion between the JAX package's haiku trees and the port's
state dicts.

Works on plain numpy dicts keyed as haiku keys them, and never imports JAX:

    params["manager"]["incep0/conv1/conv"] = {"w": DHWIO, "b": ...}
    params["manager"]["fc1/linear"]        = {"w": [in, out], "b": ...}
    params["manager"]["incep0/conv1/bn"]   = {"gamma": ..., "beta": ...}
    state["manager"]["incep0/conv1/bn"]    = {"ema_mean", "ema_var", "bias"}
    params["group{gi}"][...]               the same with a leading axis G:
                                           member j is expert
                                           groups[gi].indices[j]

In the port the same leaves sit at `manager.backbone.incep0.conv1.conv.w`,
`manager.head.fc1.linear.w`, `experts.{i}.backbone...`; conv kernels are
OIDHW, linear weights [out, in].

The ablation models have one flat haiku tree, each module path prefixed by
its CNN's name (the model class's `HAIKU_NETS`, {torch net: haiku
prefix}): the single- and multi-scale models' `incep0/conv1/conv` and
`fc1/linear` are `net.backbone.incep0.conv1.conv` and `net.head.fc1.linear`;
the switching model's `noise_incep0/...`, `large_fc1/...` and `small_...`
are `noise.backbone.incep0...`, `large.head.fc1...` and `small....`.  The flatten before the first FC layer is
in NDHWC order in both packages, so every FC weight converts by a plain
transpose.

The optimizer state converts by the same paths and transposes: optax's
`ScaleByAdamState(count, mu, nu)` is torch.optim.Adam's `step`,
`exp_avg` and `exp_avg_sq` per parameter, and optax.sgd's `TraceState`
trace is SGD's `momentum_buffer`.  optax's states arrive as the first element of
the optimizer's state tuple: optax objects with those fields, or the
plain dicts that a decoded flax checkpoint holds (the tuple keyed "0",
"1", ..., each state keyed by field name).  They leave as plain dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import MODELS
from .models.experts import expert_groups

PARAM_NAMES = ("w", "b", "gamma", "beta")  # the rest is BatchNorm state


def _to_torch_leaf(name: str, value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if name == "w" and a.ndim == 5:
        a = a.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    elif name == "w" and a.ndim == 2:
        a = a.T  # [in, out] -> [out, in]
    return torch.from_numpy(np.array(a, order="C"))  # keeps 0-d leaves 0-d


def _to_haiku_leaf(name: str, value: torch.Tensor) -> np.ndarray:
    a = value.detach().cpu().numpy().astype(np.float32)
    if name == "w" and a.ndim == 5:
        a = a.transpose(2, 3, 4, 1, 0)  # OIDHW -> DHWIO
    elif name == "w" and a.ndim == 2:
        a = a.T
    return np.array(a, order="C")


def net_path(hk_path: str) -> str:
    """haiku module path of a ConvNet -> torch module path."""
    top = "head" if hk_path.startswith("fc") else "backbone"
    return f"{top}.{hk_path.replace('/', '.')}"


def _hk_path(torch_path: str) -> str:
    """Inverse of `net_path`."""
    _, rest = torch_path.split(".", 1)
    return rest.replace(".", "/")


def module_to_torch(params: dict, state: dict, rename=None, prefix: str = "") -> dict:
    """One haiku transform's flat params/state -> torch state dict entries.
    `rename` maps a haiku module path to a torch module path (default: "/"
    becomes ".")."""
    rename = rename or (lambda p: p.replace("/", "."))
    out = {}
    for tree in (params, state):
        for path, leaves in tree.items():
            for name, value in leaves.items():
                out[f"{prefix}{rename(path)}.{name}"] = _to_torch_leaf(name, value)
    return out


def haiku_nets(cfg) -> dict | None:
    """{torch net: haiku prefix} of an ablation model; None for the
    mixture of experts, whose tree is nested by manager and group."""
    return getattr(MODELS[cfg.model], "HAIKU_NETS", None)


def from_haiku(params: dict, state: dict, cfg) -> dict:
    """haiku (params, state) of `cfg.model` -> torch state dict."""
    nets = haiku_nets(cfg)
    if nets is not None:
        sd = {}
        for net, prefix in nets.items():
            def strip(tree, prefix=prefix):
                return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}
            sd.update(module_to_torch(strip(params), strip(state), net_path, f"{net}."))
        return sd
    sd = module_to_torch(params["manager"], state["manager"], net_path, "manager.")
    for gi, group in enumerate(expert_groups(cfg)):
        gp, gs = params[f"group{gi}"], state[f"group{gi}"]
        for j, i in enumerate(group.indices):
            sd.update(module_to_torch(
                _member(gp, j), _member(gs, j), net_path, f"experts.{i}."
            ))
    return sd


def _member(tree: dict, j: int) -> dict:
    """Member j of a group's stacked haiku tree."""
    return {
        path: {name: np.asarray(v)[j] for name, v in leaves.items()}
        for path, leaves in tree.items()
    }


def _split(entries: dict) -> tuple[dict, dict]:
    """{torch module path: {leaf: array}} -> haiku (params, state)."""
    params, state = {}, {}
    for path, leaves in entries.items():
        hk = _hk_path(path)
        for name, value in leaves.items():
            tree = params if name in PARAM_NAMES else state
            tree.setdefault(hk, {})[name] = value
    return params, state


def _flat_to_haiku(state_dict: dict, nets: dict) -> tuple[dict, dict]:
    by_net: dict[str, dict] = {}
    for key, value in state_dict.items():
        net, rest = key.split(".", 1)
        path, name = rest.rsplit(".", 1)
        by_net.setdefault(net, {}).setdefault(path, {})[name] = _to_haiku_leaf(name, value)
    params, state = {}, {}
    for net, prefix in nets.items():
        p, s = _split(by_net[net])
        params.update({prefix + k: v for k, v in p.items()})
        state.update({prefix + k: v for k, v in s.items()})
    return params, state


def to_haiku(state_dict: dict, cfg) -> tuple[dict, dict]:
    """torch state dict of `cfg.model` -> haiku (params, state)."""
    nets = haiku_nets(cfg)
    if nets is not None:
        return _flat_to_haiku(state_dict, nets)
    by_net: dict[str, dict] = {}
    for key, value in state_dict.items():
        if key.startswith("manager."):
            net, rest = "manager", key[len("manager."):]
        elif key.startswith("experts."):
            _, idx, rest = key.split(".", 2)
            net = f"experts.{idx}"
        else:
            raise KeyError(f"unexpected state dict key: {key}")
        path, name = rest.rsplit(".", 1)
        by_net.setdefault(net, {}).setdefault(path, {})[name] = _to_haiku_leaf(name, value)

    params, state = {}, {}
    params["manager"], state["manager"] = _split(by_net["manager"])
    for gi, group in enumerate(expert_groups(cfg)):
        members = [_split(by_net[f"experts.{i}"]) for i in group.indices]
        for tree_i, out in ((0, params), (1, state)):
            first = members[0][tree_i]
            out[f"group{gi}"] = {
                path: {
                    name: np.stack([m[tree_i][path][name] for m in members])
                    for name in leaves
                }
                for path, leaves in first.items()
            }
    return params, state


def optimizer_state_from_optax(opt_state, model, cfg, names: list | None = None) -> dict:
    """optax state of `make_optimizer` (JAX `train_step.py:28-34`), as
    optax objects or as a decoded checkpoint's dicts -> the `state` of the
    torch optimizer's state dict, keyed by the index of each parameter in
    `names` (default: `model.named_parameters()`)."""
    inner = opt_state["0"] if isinstance(opt_state, dict) else opt_state[0]
    fields = inner if isinstance(inner, dict) else inner._asdict()
    names = names or [n for n, _ in model.named_parameters()]

    def by_name(tree):  # a tree shaped like the haiku params, without state
        return from_haiku(tree, {top: {} for top in tree}, cfg)

    if "mu" in fields:
        mu, nu = by_name(fields["mu"]), by_name(fields["nu"])
        step = float(np.asarray(fields["count"]))
        return {i: {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                for i, n in enumerate(names)}
    if "trace" in fields:
        trace = by_name(fields["trace"])
        return {i: {"momentum_buffer": trace[n]} for i, n in enumerate(names)}
    raise ValueError(f"unknown optax state with fields {sorted(fields)}")


def optimizer_state_to_optax(optimizer, model, cfg) -> dict:
    """A torch Adam or SGD (momentum) state -> {"count", "mu", "nu"} or
    {"trace"}, the moments as haiku-shaped trees of numpy arrays."""
    names = [n for n, _ in model.named_parameters()]
    state = optimizer.state_dict()["state"]

    def tree(key):
        return to_haiku({n: state[i][key] for i, n in enumerate(names)}, cfg)[0]

    first = state[0]
    if "exp_avg" in first:
        return {"count": int(first["step"].item()), "mu": tree("exp_avg"),
                "nu": tree("exp_avg_sq")}
    if "momentum_buffer" in first:
        return {"trace": tree("momentum_buffer")}
    raise ValueError(f"unknown torch optimizer state: {sorted(first)}")


def optimizer_state_by_name(optimizer: dict, names: list) -> dict:
    """{parameter name: its state} of a torch optimizer state dict whose
    parameters are `names`, in order."""
    return {names[i]: state for i, state in optimizer["state"].items()}


def optimizer_state_for(optimizer: dict, names: list, by_name: dict) -> dict:
    """The state dict of an optimizer of one parameter group over the
    parameters `names`, in order: each one's state from `by_name`, the
    group's settings from `optimizer`'s (a one-process checkpoint's layout
    for the whole model's names, an expert rank's for its own)."""
    return {"state": {i: by_name[n] for i, n in enumerate(names) if n in by_name},
            "param_groups": [dict(optimizer["param_groups"][0],
                                  params=list(range(len(names))))]}
