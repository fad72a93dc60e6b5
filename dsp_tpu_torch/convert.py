"""Carry stream state between dsp_tpu and dsp_tpu_torch.

Neither package has weights: both derive every coefficient from the same
chain string. What has to cross is the live stream state. dsp_tpu holds it
as a jax pytree (a list with one entry per runtime effect); the port holds
the same nesting of tuples, lists and dicts with torch tensors as leaves.
Leaves are taken depth first, in jax's order (a dict's values by sorted
key), so ``leaf_i`` means the same array in both packages' checkpoints
(``CompiledChain.save_state``).

``states_to_numpy`` / ``states_from_numpy`` map between the port's states
and dsp_tpu's flat list of leaves (``jax.tree_util.tree_leaves``);
``flatten_states`` also gives the string jax prints for the structure
(``str(jax.tree_util.tree_structure(states))``), which checkpoints store.
"""

import numpy as np
import torch


def flatten_states(states):
    """states -> (leaves in depth-first order, the jax treedef string)."""
    leaves = []

    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, list):
            return "[" + ", ".join(walk(c) for c in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(c) for c in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(states)})"


def unflatten_states(template, leaves):
    """Rebuild `template`'s nesting with `leaves` (depth-first) in place of
    its leaves."""
    n = len(flatten_states(template)[0])
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a state structure of {n}")
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(build(c) for c in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def states_to_numpy(states):
    """The port's states -> dsp_tpu's leaves: a list of numpy arrays."""
    leaves, _ = flatten_states(states)
    return [t.detach().to("cpu").numpy() for t in leaves]


def states_from_numpy(leaves, device):
    """dsp_tpu's leaves (numpy or anything np.asarray takes) -> a list of
    tensors, keeping each leaf's dtype. `device` is one device for every
    leaf, or a list with one device per leaf. Rebuild the nesting with
    unflatten_states(compiled_chain.states, tensors)."""
    devices = device if isinstance(device, (list, tuple)) else [device] * len(leaves)
    return [torch.as_tensor(np.array(a), device=d) for a, d in zip(leaves, devices)]
