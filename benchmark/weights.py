"""Seeded network weights, made on the device in one draw per tensor
name for all objects at once.

The layout (names and shapes) is the program's checkpoint format, read from
an instance of its module; the values are the benchmark's: He-normal
kernels (so that activations keep their scale through the LeakyReLUs of a
network whose BatchNorms hold unit statistics), zero biases, BatchNorm
scale 1 + N(0, 0.05), shift N(0, 0.05), statistics (0, 1). The error
head's bias is -4, so every detection passes the confidence gates and
reaches PnP.

:func:`passthrough` then sets a paper generator so that it returns its
input colours (as ``tests/test_torch_eval_cli.py`` builds one): served on
frames coloured by their model coordinates, it yields correspondences that
converge to the object's pose, as a trained generator's do.
"""

from __future__ import annotations

import math

import torch


def _fan_in(name: str, shape) -> int:
    if len(shape) == 4:
        # a transposed conv stores (in, out, k, k), a conv (out, in, k, k)
        cin = shape[0] if _transposed(name) else shape[1]
        return cin * shape[2] * shape[3]
    return shape[1]


def _transposed(name: str) -> bool:
    parts = name.split(".")
    return any(p.startswith("head_") or p == "deconv" for p in parts)


def seeded_state(template: dict, n: int, gen: torch.Generator,
                 device, prob_bias: float | None = -4.0) -> list[dict]:
    """``n`` state dicts with ``template``'s names and shapes."""
    out = [dict() for _ in range(n)]
    for name, ref in template.items():
        shape = tuple(ref.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            vals = torch.zeros((n,) + shape, dtype=ref.dtype, device=device)
        elif leaf == "running_mean":
            vals = torch.zeros((n,) + shape, device=device)
        elif leaf == "running_var":
            vals = torch.ones((n,) + shape, device=device)
        elif _is_bn(name, template):
            noise = 0.05 * torch.randn((n,) + shape, generator=gen,
                                       device=device)
            vals = noise + (1.0 if leaf == "weight" else 0.0)
        elif leaf == "weight":
            std = math.sqrt(2.0 / _fan_in(name, shape))
            vals = std * torch.randn((n,) + shape, generator=gen,
                                     device=device)
        else:
            vals = torch.zeros((n,) + shape, device=device)
            if prob_bias is not None and name.startswith("head_prob"):
                vals.fill_(prob_bias)
        for i in range(n):
            out[i][name] = vals[i]
    return out


def _is_bn(name: str, template: dict) -> bool:
    return name.rsplit(".", 1)[0] + ".running_mean" in template


LEAK = 0.3


def passthrough(state: dict, gain: float, error_logit: float,
                error_weight_std: float = 0.25):
    """A paper generator's seeded ``state`` changed in place so that its
    coordinate map is tanh(gain * x) of the input colour x at each 2x2
    block's lower-right pixel, and its error map sigmoid(error_logit + a
    seeded field that varies with the image). The encoder's stride-2 skip
    conv ``e1_2`` splits each channel into the LeakyReLU's two halves, the
    first six channels of ``d3_uni`` join them again (identity BatchNorms)
    and read nothing else, ``head_xyz`` replicates each 2x2 block of them.
    The error head reads the other channels of ``d3_uni``, which read the
    whole network: an ``error_logit`` a little below the logit of
    ``inlier_th`` keeps some points from PnP, as a trained head's map does,
    and a change in the precision of those layers moves points across that
    threshold. Every other layer keeps its seeded weights and runs."""
    if state["d3_uni.conv.weight"].shape[1] != 128:
        raise ValueError("passthrough is written for the paper generator, "
                         "whose d3_uni reads [d3 (64), e1_2 (64)]")
    for name in ("encoder.e1_2.bn.", "d3_uni.bn."):
        state[name + "weight"].fill_(1.0)
        state[name + "bias"].zero_()
        state[name + "running_mean"].zero_()
        state[name + "running_var"].fill_(1.0 - 1e-3)    # eps 1e-3
    split = state["encoder.e1_2.conv.weight"]
    split.zero_()
    state["encoder.e1_2.conv.bias"].zero_()
    join = state["d3_uni.conv.weight"]
    join[:6].zero_()
    state["d3_uni.conv.bias"].zero_()
    head = state["head_xyz.weight"]
    head.zero_()
    state["head_xyz.bias"].zero_()
    for c in range(3):
        split[c, c, 2, 2] = 1.0
        split[3 + c, c, 2, 2] = -1.0
        for o, sign in ((c, 1.0), (3 + c, -1.0)):
            # lrelu(x) - lrelu(-x) = (1 + LEAK) x
            join[o, 64 + c, 2, 2] = sign / (1.0 + LEAK)
            join[o, 64 + 3 + c, 2, 2] = -sign / (1.0 + LEAK)
        head[c, c, 1:3, 1:3] = gain / (1.0 + LEAK)
        head[3 + c, c, 1:3, 1:3] = -gain / (1.0 + LEAK)
    # logit std ~0.5 at error_weight_std 0.25
    prob = state["head_prob.weight"]
    prob[:6].zero_()
    prob[6:] *= error_weight_std / prob[6:].std().clamp(min=1e-12)
    state["head_prob.bias"].fill_(error_logit)
