"""The port's mixed-precision (AMP) training step with a Swin backbone against
the JAX package's ``amp=True`` on the CPU, at the tiny Swin MDQE
configuration of ``tests/test_torch_swin_paths.py`` (embed 32, depths
2-2-2-2, window 4; hidden 64, 1 + 1 layers, 16 queries), dropout and drop
path 0, the same weights on both sides: v2 on unpadded 128x128 frames (the
JAX package's v2 gradient is NaN on padded windows) and v1 on 128x160, whose
stage grids pad to their windows. Under AMP the backbone runs and
differentiates in bf16: v2's cosine attention and its continuous position
bias, v1's bias table, the shifted-window masks and PatchMerging.

  - the loss dict as a vector, held to a multiple of JAX's own AMP-vs-fp32
    distance (JAX's fp32 losses equal the port's fp32 ones within 1e-4,
    tests/test_torch_swin_paths.py, so the port's fp32 losses stand for
    them);
  - the gradients of the whole loss against ``jax.value_and_grad`` at
    ``amp=True``, by cosine, overall and per leaf, and closer to JAX's AMP
    gradients than the port's fp32 gradients are.

As in tests/test_torch_amp.py, the two frameworks round bf16 at other places
and argmax decisions can flip under a rounding, so the comparisons are by
distance and direction. JAX is compiled once per case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_swin_paths as tsp
from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.losses import CriterionCfg as JCritCfg
from mdqe_cvpr2023_tpu.losses.criterion import criterion_apply as j_criterion
from mdqe_cvpr2023_tpu.models import decoder as jdec
from mdqe_cvpr2023_tpu.models import detr as jdetr
from mdqe_cvpr2023_tpu.parallel import train as jtrain
from mdqe_cvpr2023_tpu_torch.engine.weights import grad_state_dict
from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
from mdqe_cvpr2023_tpu_torch.parallel import train as ttrain

torch.set_num_threads(2)

B, T, HP, N = tsp.B, tsp.T, tsp.HP, tsp.N


@pytest.fixture(scope="module", params=sorted(tsp.STEP_CASES))
def amp_steps(request):
    """JAX's AMP loss dict and gradients (value_and_grad of make_train_step's
    loss at amp=True); the port's loss dict and gradients at AMP and at fp32,
    each from a fresh model with the same weights."""
    swin_kw, WP = tsp.STEP_CASES[request.param]
    batch = ttrain.synthetic_batch(seed=3, clips=B, frames=T, hp=HP, wp=WP, slots=N,
                                   n_inst=2, num_classes=5)
    params = tsp._tree(tsp._new_model(swin_kw))
    jcfg = tsp._cfgs(swin_kw, num_classes=5, n_frames=T)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    relpos = jnp.asarray(jdec.query_relpos_grid(4))
    mean = jnp.asarray(ttrain.PIXEL_MEAN, jnp.float32)
    std = jnp.asarray(ttrain.PIXEL_STD, jnp.float32)

    def loss_fn(p):
        images = (jb["images"].astype(jnp.float32) - mean) / std
        out = jdetr.detr_apply_backbone(p, jcfg, images, jb["image_sizes"], n_frames=T,
                                        training=True, drop_rate=0.0,
                                        rng=jax.random.fold_in(key, 999), amp=True)
        mm, m8 = jtrain.prepare_targets_device(jb["masks"], (HP, WP), 4)
        tg = {"labels": jb["labels"], "ids": jb["ids"], "boxes": jb["boxes"],
              "valid": jb["valid"], "match_masks": mm, "masks8": m8}
        return j_criterion(JCritCfg(**tsp.CRIT), out, tg, relpos, key, amp=True)

    (total, ldict), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = {}
    for amp in (True, False):
        model = tsp._new_model(swin_kw)
        ttrain.make_optimizer(model, ttrain.TrainCfg(amp=amp))  # marks the trainable set
        t_total, t_ldict = ttrain.loss_fn(
            model, CriterionCfg(**tsp.CRIT), {k: torch.from_numpy(np.ascontiguousarray(v))
                                              for k, v in batch.items()},
            dropout_rate=0.0, reid_priorities=torch.from_numpy(tsp.reid_priorities(key)),
            amp=amp)
        t_total.backward()
        assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == p.dtype)
                   for p in model.parameters())
        port[amp] = (t_total.item(), {k: v.item() for k, v in t_ldict.items()},
                     convert_torch_state_dict(grad_state_dict(model)))
    return {"case": request.param, "total": float(total),
            "ldict": {k: float(v) for k, v in ldict.items()}, "grads": grads, "port": port,
            "frozen": jtrain.frozen_leaf_mask(params, 2)}


# per case: the loss vector's distance to JAX's AMP as a multiple of JAX's own
# AMP-vs-fp32 distance, the total's relative error, and the least cosine to
# JAX's AMP gradients overall, over the backbone and per leaf. v2 is noisier:
# its cosine logits, scaled by up to 100 before the fp32 softmax, are bf16, so
# a one-ulp difference upstream moves a logit by up to 2^-4 and can flip a
# matched query's box (its loss_bbox moves +0.149 in the port and -0.081 in
# JAX against fp32); a single v2 window attention of the two frameworks on
# the same bf16 inputs lies 0.9x JAX's own bf16-vs-fp32 distance apart
# (v1 1.0x), so neither rounds at a place the other does not.
LIMITS = {"v1": dict(loss=0.5, total=1e-2, overall=0.99, backbone=0.99, leaf=0.75),
          "v2": dict(loss=2.0, total=2e-2, overall=0.93, backbone=0.9, leaf=0.45)}


def test_swin_amp_losses_within_jax_own_amp_distance(amp_steps):
    """The port's AMP loss dict (every weighted loss, as a vector) against
    JAX's: v1 within 0.5x JAX's own AMP-vs-fp32 distance (measured 0.014x),
    v2 within 2x (measured 1.36x, nearly all of it loss_bbox: two AMP runs
    whose roundings are independent lie about sqrt(2)x apart); the total
    within 1e-2 (v1, measured 2.5e-4) and 2e-2 (v2, 8.6e-3) relative. v2's
    loss vector cannot tell AMP from fp32; its gradients can (below)."""
    lim = LIMITS[amp_steps["case"]]
    ld = amp_steps["port"][True][1]
    ld32 = amp_steps["port"][False][1]
    want = amp_steps["ldict"]
    keys = sorted(want)
    assert sorted(ld) == sorted(ld32) == keys
    got = np.array([ld[k] for k in keys])
    jamp = np.array([want[k] for k in keys])
    own = np.linalg.norm(jamp - np.array([ld32[k] for k in keys]))
    assert own > 0
    assert np.linalg.norm(got - jamp) <= lim["loss"] * own, np.linalg.norm(got - jamp) / own
    np.testing.assert_allclose(amp_steps["port"][True][0], amp_steps["total"],
                               rtol=lim["total"])


def test_swin_amp_gradients_point_as_jax_amp_gradients(amp_steps):
    """The AMP gradients of the whole loss against JAX's AMP gradients over
    the trainable leaves, by cosine. Overall at least 0.99 for v1 (measured
    0.998) and 0.93 for v2 (0.946); over the backbone's leaves at least 0.99
    (0.998) and 0.9 (0.922); both at least 0.01 above the port's fp32
    gradients' cosine to JAX's AMP ones (overall 0.967 and 0.915, backbone
    0.952 and 0.882), so a port whose AMP ran in fp32 fails. Per leaf at
    least 0.75 for v1 (measured 0.798) and 0.45 for v2 (0.492, a decoder
    leaf; 0.813 at least in the backbone) where the leaf's largest JAX
    gradient is above 1e-2 of the model's largest and its fp32 gradient is
    not zero up to rounding (above 1e-4 of the model's largest fp32
    gradient), and every Swin stage has such leaves."""
    lim = LIMITS[amp_steps["case"]]
    paths = jax.tree_util.tree_flatten_with_path(amp_steps["grads"])[0]
    amp = jax.tree_util.tree_leaves(amp_steps["port"][True][2])
    f32 = jax.tree_util.tree_leaves(amp_steps["port"][False][2])
    frozen = jax.tree_util.tree_leaves(amp_steps["frozen"])
    assert len(amp) == len(f32) == len(paths) == len(frozen)
    rows = [(jax.tree_util.keystr(kp), np.asarray(a, np.float64).ravel(),
             np.asarray(b, np.float64).ravel(), np.asarray(j, np.float64).ravel())
            for (kp, j), a, b, f in zip(paths, amp, f32, frozen) if not f]
    assert all(np.isfinite(r[1]).all() and np.isfinite(r[3]).all() for r in rows)

    def cos(x, y):
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))

    def cosines(sel):
        a, b, j = (np.concatenate([r[i] for r in sel]) for i in (1, 2, 3))
        return cos(a, j), cos(b, j)
    for name, sel in (("overall", rows),
                      ("backbone", [r for r in rows if r[0].startswith("['backbone']")])):
        c, c32 = cosines(sel)
        assert c >= lim[name] and c >= c32 + 0.01, (name, c, c32)
    G = max(np.abs(r[3]).max() for r in rows)
    G32 = max(np.abs(r[2]).max() for r in rows)
    stages = set()
    for path, a, b, j in rows:
        if np.abs(j).max() > 1e-2 * G and np.abs(b).max() > 1e-4 * G32:
            assert cos(a, j) >= lim["leaf"], (path, cos(a, j))
            if path.startswith("['backbone']['layers']"):
                stages.add(path.split("['layers']")[1][:3])
    assert stages == {"[0]", "[1]", "[2]", "[3]"}, stages
