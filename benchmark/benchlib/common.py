"""What the kinds of cell share: the run's context, the models of both
sides built from a configuration file, and the comparison of a reading
against its limit."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class Ctx:
    cell: object                  # manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    sut: str = "program"          # "program", or "control": the reference one step lower
    t0: float = 0.0               # the process's start (host clock)


def salted(seed: int, salt: int) -> int:
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + salt) % (2 ** 63 - 1)


def _swin(cls, swin: dict):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in swin.items()})


def model_cfg(config: dict, detr_mod, swin_mod):
    m = dict(config["model"])
    if "swin" in m:
        m["swin"] = _swin(swin_mod.SwinCfg, m["swin"])
    return detr_mod.MDQEModelCfg(**m)


def inference_cfg(config: dict, gates: str, cls):
    """The config's inference settings with the traffic's gates: "config"
    keeps them, "off" opens them (threshold 0, no dedup, no repeat
    suppression: the tracker fills to its capacity)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    inf = {k: v for k, v in config["inference"].items() if k in fields}
    if gates == "off":
        inf.update(apply_cls_thres=0.0, dedup_sim=2.0, suppress_siou=2.0, suppress_ctt=2.0)
    elif gates != "config":
        raise ValueError(f"gates is config or off, not {gates}")
    return cls(**inf)


def check(name: str, value: float, limits: dict) -> dict:
    """One compared number beside its limit; a number with no limit in the
    cell's limits file fails."""
    limit = limits.get(name)
    ok = limit is not None and value == value and value <= limit
    return {"name": name, "value": float(value), "limit": limit, "ok": bool(ok)}


def free_device(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
