"""The model's weights, made by the benchmark from the seed on the device.

Uniform numbers in [-1, 1) drawn on the device in one call from a
``torch.Generator`` with a fixed seed (``BASE_SEED``), each scaled by
1 + ``JITTER`` u, u uniform in [-1, 1) drawn in one call from the run's seed:
every seed gets its own weights, all near one model, so that every seed
gives the tracker the same amount of work (its host assignment's cost
follows the model's scores; fully independent draws moved a run's clips/s
by half, 5% draws by a fifth). The draw is cut into the parameters in the order of their
(Detectron2) names, each scaled by a rule on its name and shape: weight matrices and kernels by 1 / sqrt(fan in) (the ResNet's
convolutions by sqrt(6 / fan in), He's bound), biases by 1 / sqrt(fan in) of
their layer's weight, norm gains 1 and norm biases 0, the encoder's
level embedding at unit variance, the class heads' last bias at the focal
prior -log(99), Swin v2's logit scales at log(10), and the
encoder's sampling-offset bias on Deformable DETR's grid of directions. Both
sides load the same tensors strictly (``load``): the program's model and
the reference's. Buffers are each side's own constants.
"""
from __future__ import annotations

import math

import torch


def _grid_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Deformable DETR's sampling-offset bias: head h points along the angle
    2 pi h / H, point p at (p + 1) times the unit step, on every level."""
    theta = torch.arange(n_heads, dtype=torch.float64) * (2.0 * math.pi / n_heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    grid = grid * torch.arange(1, n_points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


def _rule(name: str, shape, shapes: dict, model_cfg: dict):
    """(kind, value) for one parameter: ("scale", bound of its uniform draw)
    or ("const", a tensor or number)."""
    if name.endswith("logit_scale"):
        return "const", math.log(10.0)
    if name.endswith("cls_embed.layers.2.bias"):
        return "const", -math.log((1 - 0.01) / 0.01)  # the focal prior, p = 0.01
    if name.endswith("level_embed"):
        return "scale", math.sqrt(3.0)
    if name.startswith("detr.transformer_enc.") and name.endswith("sampling_offsets.bias"):
        return "const", _grid_bias(model_cfg["n_heads"], model_cfg["n_feature_levels"],
                                   model_cfg["enc_points"])
    if len(shape) == 1:
        if name.endswith(".weight"):
            return "const", 1.0
        sibling = shapes.get(name[:-len("bias")] + "weight")
        if sibling is None or len(sibling) < 2:
            return "const", 0.0
        return "scale", 1.0 / math.sqrt(math.prod(sibling[1:]))
    fan_in = math.prod(shape[1:])
    if name.startswith("detr.backbone.") and len(shape) == 4 and "resnet" in model_cfg["backbone"]:
        return "scale", math.sqrt(6.0 / fan_in)
    return "scale", 1.0 / math.sqrt(fan_in)


BASE_SEED = 0x4D445145
JITTER = 0.01


def make_weights(param_shapes: dict, model_cfg: dict, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} for the parameters ``param_shapes``
    ({name: shape}, in the model's order), from ``seed``."""
    total = sum(math.prod(s) for s in param_shapes.values())
    base = torch.Generator(device=device).manual_seed(BASE_SEED)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=base, device=device).mul_(2.0).sub_(1.0)
    draw.mul_(torch.rand(total, generator=gen, device=device).mul_(2.0 * JITTER)
              .add_(1.0 - JITTER))
    out, offset = {}, 0
    for name, shape in param_shapes.items():
        n = math.prod(shape)
        kind, value = _rule(name, shape, param_shapes, model_cfg)
        if kind == "scale":
            out[name] = draw[offset:offset + n].view(shape) * value
        elif isinstance(value, torch.Tensor):
            out[name] = value.to(device).view(shape).clone()
        else:
            out[name] = torch.full(shape, float(value), device=device)
        offset += n
    return out


def param_shapes(model: torch.nn.Module) -> dict:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into every parameter of ``model`` (strict: each name
    present on both sides); the buffers stay the model's own."""
    state = dict(weights)
    state.update({n: b for n, b in model.named_buffers()
                  if n in model.state_dict()})
    model.load_state_dict(state, strict=True)
