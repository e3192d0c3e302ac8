"""The port's training slice against the JAX package on the CPU, at the TINY
configuration of ``tests/test_train_step.py`` (hidden 64, 1+1 layers, 16
queries, 2-frame clips), fp32 on both sides, dropout 0:

  - the training forward (encoder, decoder and ``detr_apply_backbone``);
  - the loss dict and the parameter gradients of the whole loss against
    ``jax.value_and_grad`` of ``make_train_step``'s loss composition, the
    port's gradients mapped to the JAX tree by the JAX package's own
    Detectron2-name converter;
  - the parameters after one optimizer step against
    ``make_train_step(dropout_rate=0.0)``;
  - the frozen set against ``frozen_leaf_mask``; dropout.

Weights are made by the port (seeded init plus noise) and handed to JAX; the
reid priorities are the draws JAX makes from the step's key. Frames are
128x128 so that no pyramid level is 1x1 (GroupNorm over two values there makes
the extra level's gradient ill-conditioned in both frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.losses import CriterionCfg as JCritCfg
from mdqe_cvpr2023_tpu.losses.criterion import criterion_apply as j_criterion
from mdqe_cvpr2023_tpu.models import decoder as jdec
from mdqe_cvpr2023_tpu.models import detr as jdetr
from mdqe_cvpr2023_tpu.parallel import train as jtrain
from mdqe_cvpr2023_tpu_torch.engine.weights import grad_state_dict
from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
from mdqe_cvpr2023_tpu_torch.models import detr as tdetr
from mdqe_cvpr2023_tpu_torch.models import encoder as tenc
from mdqe_cvpr2023_tpu_torch.parallel import train as ttrain
from mdqe_cvpr2023_tpu_torch.utils import nn as tnn

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
            enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
            query_embed_dim=8, dec_temporal=True)
CRIT = dict(num_classes=5, n_frames=2, n_query=16, window_inter_frame_asso=5,
            num_points=64)
B, T, HP, WP, N = 2, 2, 128, 128, 3
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_batch(seed=0):
    """Two valid instances of three slots per clip, each with its own box and
    mask in every frame; raw uint8 frames."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, N, T, HP, WP), np.float32)
    boxes = np.zeros((B, N, T, 4), np.float32)
    labels = np.zeros((B, N), np.int32)
    ids = np.full((B, N, T), -1, np.int32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        for n in range(2):
            for t in range(T):
                x0, y0 = rng.integers(0, HP // 2, 2)
                w, h = rng.integers(20, 56, 2)
                masks[b, n, t, y0:y0 + h, x0:x0 + w] = 1.0
                boxes[b, n, t] = [x0 / WP, y0 / HP, min(x0 + w, WP) / WP,
                                  min(y0 + h, HP) / HP]
            labels[b, n] = rng.integers(0, 5)
            ids[b, n] = n
            valid[b, n] = True
    return {"images": rng.integers(0, 255, (B * T, HP, WP, 3)).astype(np.uint8),
            "image_sizes": np.tile([[HP, WP]], (B * T, 1)).astype(np.int32),
            "labels": labels, "ids": ids, "boxes": boxes, "masks": masks,
            "valid": valid}


def jax_reid_priorities(key, n_query):
    """The uniform draws ``criterion_apply`` makes from ``key`` for the reid
    loss (split per video, per instance, then into (positive, negative)),
    as a (B, N, 2, T*Q) array."""
    TQ = T * n_query
    out = np.zeros((B, N, 2, TQ))
    for b, kb in enumerate(jax.random.split(key, B)):
        for n, kn in enumerate(jax.random.split(kb, N)):
            k1, k2 = jax.random.split(kn)
            out[b, n, 0] = np.asarray(jax.random.uniform(k1, (TQ,)))
            out[b, n, 1] = np.asarray(jax.random.uniform(k2, (TQ,)))
    return out


@torch.no_grad()
def _perturb_(module, seed):
    """Noise on every weight so that zero-initialized heads take part."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if name.endswith(("sampling_offsets", "lvl_spatial_scales")):
            continue  # fixed buffers
        if name.endswith("running_var"):
            t.mul_(torch.empty_like(t).uniform_(0.5, 1.5, generator=gen))
        else:
            t.add_(0.05 * torch.randn(t.shape, generator=gen))


def _tree(model):
    return convert_torch_state_dict({k: v.detach().numpy()
                                     for k, v in model.state_dict().items()})


def _new_model():
    model = tdetr.MDQEModel(tdetr.MDQEModelCfg(**TINY), device="cpu", seed=0)
    _perturb_(model, 1)
    return model


@pytest.fixture(scope="module")
def jax_step():
    """The JAX side, computed once: loss dict and gradients of the loss
    composition, and the parameters after one ``make_train_step`` step."""
    params = _tree(_new_model())
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jdetr.MDQEModelCfg(**TINY)
    crit = JCritCfg(**CRIT)
    key = jax.random.PRNGKey(1)
    relpos = jnp.asarray(jdec.query_relpos_grid(4))
    mean, std = jnp.asarray(MEAN, jnp.float32), jnp.asarray(STD, jnp.float32)

    def loss_fn(p):  # make_train_step's loss_fn, dropout 0
        images = (jb["images"].astype(jnp.float32) - mean) / std
        out = jdetr.detr_apply_backbone(p, cfg, images, jb["image_sizes"], n_frames=T,
                                        training=True, drop_rate=0.0,
                                        rng=jax.random.fold_in(key, 999))
        mm, m8 = jtrain.prepare_targets_device(jb["masks"], (HP, WP), 4)
        tg = {"labels": jb["labels"], "ids": jb["ids"], "boxes": jb["boxes"],
              "valid": jb["valid"], "match_masks": mm, "masks8": m8}
        total, ldict = j_criterion(crit, out, tg, relpos, key)
        return total, (ldict, out)

    (total, (ldict, out)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jtrain.make_optimizer(jtrain.TrainCfg())
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    step = jtrain.make_train_step(cfg, crit, tx, dropout_rate=0.0)
    params1, _, _, _ = step(jax.tree.map(jnp.array, params), tx.init(params), jb, key)
    return {"params": params, "batch": batch, "key": key,
            "priorities": jax_reid_priorities(key, CRIT["n_query"]),
            "total": float(total), "ldict": {k: float(v) for k, v in ldict.items()},
            "out": out, "grads": grads, "params1": params1,
            "params1_from_grads": jax.tree.map(lambda p, u: p + u, params, updates),
            "frozen": jtrain.frozen_leaf_mask(params, 2)}


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _trainable_leaves(tree_a, tree_b, frozen):
    """(path, a, b) over the leaves that frozen_leaf_mask leaves trainable."""
    flat_a = jax.tree_util.tree_flatten_with_path(tree_a)[0]
    flat_b = jax.tree_util.tree_leaves(tree_b)
    flat_f = jax.tree_util.tree_leaves(frozen)
    assert len(flat_a) == len(flat_b) == len(flat_f)
    return [(jax.tree_util.keystr(kp), np.asarray(a, np.float64), np.asarray(b, np.float64))
            for (kp, a), b, f in zip(flat_a, flat_b, flat_f) if not f]


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------

def test_detr_apply_backbone_training_forward_matches_jax(jax_step):
    """Backbone, encoder and decoder training forward (raw frames normalized
    as the step does, drop 0) against the outputs of the JAX loss: 2e-4 of
    each output's largest magnitude (long fp32 sums in another order through
    50 convolutions, the encoder and the mask head; the proto features, up to
    4 in size, differ by 5.3e-4 at most)."""
    batch = jax_step["batch"]
    images = (_t(batch["images"]).float() - torch.tensor(MEAN)) / torch.tensor(STD)
    with torch.no_grad():
        got = tdetr.detr_apply_backbone(_new_model().detr, images,
                                        _t(batch["image_sizes"]), T)
    want = jax_step["out"]
    pairs = [(k, got[k], want[k]) for k in
             ("cls", "boxes", "mask_coeff", "proto", "query_coords")]
    pairs += [(k, got["query_init"][k], want["query_init"][k]) for k in
              ("rpn_sem_cls", "query_init_embed", "query_coords_grid")]
    for k, g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=k)


def test_decoder_training_forward_matches_jax():
    """decoder_apply(training=True) on the same encoding: every layer's
    outputs and the query-init aux, 1e-4."""
    model = _new_model()
    params = _tree(model)
    rng = np.random.default_rng(3)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))
    enc = rng.standard_normal((B * T, 85, 64)).astype(np.float32)
    mask = torch.cat([m.reshape(B * T, -1) for m in tdetr.padding_masks(
        _t(np.asarray([[60, 62], [60, 62], [50, 64], [50, 64]], np.int32)), (64, 64),
        (8, 16, 32, 64))], 1)
    with torch.no_grad():
        got = model.detr.transformer_dec.forward_train(_t(enc), mask, shapes, T)
    want = jdec.decoder_apply(params["transformer_dec"],
                              jdetr.MDQEModelCfg(**TINY).decoder_cfg, jnp.asarray(enc),
                              jnp.asarray(mask.numpy()), shapes, T, training=True)
    assert got["cls"].shape == (2, B, 16, 5) and got["boxes"].shape == (2, B, 16, T, 4)
    for k in ("cls", "boxes", "mask_coeff", "proto", "query_coords"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    for k in ("rpn_sem_cls", "query_init_embed", "query_coords_grid"):
        np.testing.assert_allclose(got["query_init"][k].numpy(),
                                   np.asarray(want["query_init"][k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_dropout_repeats_under_a_seed_and_drops_its_rate():
    x = torch.ones(200, 500)
    a = tnn.dropout(x, 0.1, torch.Generator().manual_seed(5))
    b = tnn.dropout(x, 0.1, torch.Generator().manual_seed(5))
    c = tnn.dropout(x, 0.1, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    dropped = float((a == 0).float().mean())
    assert abs(dropped - 0.1) < 0.005  # 1e5 draws: 5 standard deviations
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert tnn.dropout(x, 0.0, torch.Generator()) is x and tnn.dropout(x, 0.1) is x

    # the encoder's three dropout sites draw from the generator in training
    layer = tenc.EncoderLayer(tenc.EncoderCfg(dim=32, n_heads=4, n_levels=1,
                                              n_points=2, n_layers=1))
    rng = np.random.default_rng(0)
    xin = _t(rng.standard_normal((1, 12, 32)).astype(np.float32))
    ref = _t(np.tile([[[0.4, 0.5, 0.1, 0.1]]], (1, 12, 1)).astype(np.float32))
    args = (xin, torch.zeros_like(xin), ref, ((3, 4),), None)
    with torch.no_grad():
        eval_out = layer(*args)
        d1 = layer(*args, 0.1, torch.Generator().manual_seed(1))
        d2 = layer(*args, 0.1, torch.Generator().manual_seed(1))
        d0 = layer(*args, 0.0, torch.Generator().manual_seed(1))
    assert torch.equal(d1, d2) and torch.equal(d0, eval_out)
    assert not torch.allclose(d1, eval_out)


# --------------------------------------------------------------------------
# loss, gradients, one step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_grads(jax_step):
    model = _new_model()
    opt = ttrain.make_optimizer(model, ttrain.TrainCfg())
    opt.zero_grad()
    total, ldict = ttrain.loss_fn(model, CriterionCfg(**CRIT), _port_batch(jax_step["batch"]),
                                  dropout_rate=0.0,
                                  reid_priorities=_t(jax_step["priorities"]))
    total.backward()
    return model, opt, total.item(), {k: v.item() for k, v in ldict.items()}


def test_loss_dict_matches_jax(jax_step, port_grads):
    """Every weighted loss and the total: rtol 1e-4."""
    _, _, total, ldict = port_grads
    assert sorted(ldict) == sorted(jax_step["ldict"])
    for k, v in jax_step["ldict"].items():
        np.testing.assert_allclose(ldict[k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total, jax_step["total"], rtol=1e-4)


def test_param_grads_match_jax_value_and_grad(jax_step, port_grads):
    """Per trainable leaf, with G the largest gradient in the model and s the
    leaf's largest JAX gradient: max |err| <= 0.1 s + 1e-6 G; at most 0.5% of
    the entries off by more than 0.01 s; cosine >= 0.9999 where s > 1e-4 G.
    The loss is not smooth (ReLU and bilinear kinks), so a few entries deep in
    the backbone differ by a few percent of s (measured: 5.3% at most, 0.1%
    of a leaf's entries beyond 0.01 s, cosine >= 0.99991); leaves whose true
    gradient is zero (a bias before GroupNorm, the shift-invariant time-weight
    bias) carry only rounding noise, below 1e-7 G."""
    model = port_grads[0]
    leaves = _trainable_leaves(convert_torch_state_dict(grad_state_dict(model)),
                               jax_step["grads"], jax_step["frozen"])
    G = max(np.abs(w).max() for _, _, w in leaves)
    assert len(leaves) > 100 and G > 0
    for path, g, w in leaves:
        s = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= 0.1 * s + 1e-6 * G, f"{path}: err {err.max():.3e} s {s:.3e}"
        if s > 1e-4 * G:
            assert (err > 1e-2 * s).mean() <= 5e-3, path
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos >= 0.9999, f"{path}: cosine {cos:.6f}"


def _param_diffs(model, params1, frozen):
    """Per leaf |port - JAX| after a step; frozen leaves must be equal."""
    flat_a = jax.tree_util.tree_flatten_with_path(_tree(model))[0]
    flat_j = jax.tree_util.tree_leaves(params1)
    flat_f = jax.tree_util.tree_leaves(frozen)
    diffs, n_frozen = {}, 0
    for (kp, a), j, f in zip(flat_a, flat_j, flat_f):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(j, np.float64))
        if f:
            assert d.max() == 0, jax.tree_util.keystr(kp)
            n_frozen += 1
        else:
            diffs[jax.tree_util.keystr(kp)] = (d, np.abs(np.asarray(j, np.float64)))
    assert n_frozen > 10
    return diffs


def test_one_step_matches_make_train_step(jax_step, port_grads):
    """One step at TrainCfg() (lr 1e-4, clip 0.01) against
    make_train_step(dropout_rate=0.0).

    The port's own step: frozen leaves exactly equal; of the 25 M trainable
    entries, 99% within 0.01 lr and 99.9% within 0.05 lr (measured 0.0019 and
    0.023 lr), and all within 1.0 lr. Adam's
    first step moves an entry by lr * g / (|g| + eps), about lr * sign(g), so
    an entry whose gradient is zero up to rounding noise can move by up to lr
    either way in the two frameworks (measured: 0.71 lr at most, on such an
    entry); a sign flip of a real gradient would show as 2 lr.

    The port's optimizer fed JAX's gradients against the JAX optimizer
    applied to the same gradients: every entry within 1e-3 lr plus one fp32
    rounding of the parameter (the same arithmetic, rounded in another
    order)."""
    import copy
    model, opt, _, _ = port_grads
    twin = copy.deepcopy(model)
    lr = ttrain.TrainCfg().base_lr
    opt.step()
    diffs = _param_diffs(model, jax_step["params1"], jax_step["frozen"])
    for path, (d, _) in diffs.items():
        assert d.max() <= 1.0 * lr, f"{path}: {d.max() / lr:.3f} lr"
    q99, q999 = np.quantile(np.concatenate([d.ravel() for d, _ in diffs.values()]),
                            [0.99, 0.999])
    assert q99 <= 0.01 * lr and q999 <= 0.05 * lr, (q99 / lr, q999 / lr)

    twin_opt = ttrain.make_optimizer(twin, ttrain.TrainCfg())
    names = list(twin.state_dict())
    index_tree = convert_torch_state_dict({n: np.float32(i) for i, n in enumerate(names)})
    params = dict(twin.named_parameters())
    for idx, g in zip(jax.tree_util.tree_leaves(index_tree),
                      jax.tree_util.tree_leaves(jax_step["grads"])):
        p = params.get(names[int(idx)])
        if p is not None and p.requires_grad:
            p.grad = _t(np.asarray(g, np.float32))
    twin_opt.step()
    for path, (d, p) in _param_diffs(twin, jax_step["params1_from_grads"],
                                     jax_step["frozen"]).items():
        assert np.all(d <= 1e-3 * lr + 2.0 ** -23 * p), f"{path}: {d.max() / lr:.2e} lr"


def test_frozen_set_matches_frozen_leaf_mask(jax_step):
    """The port's frozen set (buffers, and the stem and res2 parameters, which
    get no gradient and are in no optimizer group) is the set of leaves the
    JAX mask freezes at freeze_at=2."""
    model = _new_model()
    opt = ttrain.make_optimizer(model, ttrain.TrainCfg())
    in_opt = {id(p) for g in opt.adamw.param_groups for p in g["params"]}
    params = dict(model.named_parameters())
    names = list(model.state_dict())
    index_tree = convert_torch_state_dict({n: np.float32(i) for i, n in enumerate(names)})
    mask = jtrain.frozen_leaf_mask(index_tree, 2)
    checked = 0
    for idx, frozen in zip(jax.tree_util.tree_leaves(index_tree),
                           jax.tree_util.tree_leaves(mask)):
        name = names[int(idx)]
        trainable = name in params and params[name].requires_grad
        assert frozen != trainable, name
        assert (name in params and id(params[name]) in in_opt) == trainable, name
        checked += 1
    assert checked == len(names)
    bb = [g["params"] for g in opt.adamw.param_groups]
    assert {id(p) for p in bb[0]} == {id(p) for n, p in params.items()
                                      if n.startswith("detr.backbone.") and p.requires_grad}
    assert opt.adamw.param_groups[0]["lr"] == pytest.approx(0.1 * opt.adamw.param_groups[1]["lr"])


def test_port_steps_lower_the_loss_and_keep_frozen_leaves():
    """The JAX package's check (tests/test_train_step.py): lr 1e-3, clip 1.0,
    dropout 0.1, three steps on a fixed batch lower the total; every frozen
    parameter and buffer stays bit-identical."""
    model = _new_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ttrain.make_optimizer(model, ttrain.TrainCfg(base_lr=1e-3, steps=(1000,),
                                                       clip_norm=1.0))
    step = ttrain.make_train_step(CriterionCfg(**CRIT))
    batch = _port_batch(make_batch(seed=4))
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(model, opt, batch, gen)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    for k, v in model.state_dict().items():
        if k not in trainable:
            assert torch.equal(v, before[k]), k


def test_optimizer_schedule_and_clip_follow_optax():
    """The LR at each step, counted from 0, equals the JAX optimizer's: with a
    zero parameter and a constant gradient of 1, Adam's update is exactly
    -lr / (1 + eps). The clip equals optax's clip_by_global_norm (1e-6)."""
    tc = dict(base_lr=1e-3, warmup_iters=4, warmup_factor=0.5, steps=(6, 8),
              gamma=0.1, clip_norm=0.0)
    tx = jtrain.make_optimizer(jtrain.TrainCfg(**tc))
    p = {"transformer_dec": {"w": jnp.zeros(1)}}
    state = tx.init(p)
    want = []
    for _ in range(10):
        upd, state = tx.update({"transformer_dec": {"w": jnp.ones(1)}}, state, p)
        want.append(-float(upd["transformer_dec"]["w"][0]) * (1 + 1e-8))
    got = [tc["base_lr"] * ttrain.lr_factor(ttrain.TrainCfg(**tc), s) for s in range(10)]
    np.testing.assert_allclose(got, want, rtol=1e-6)

    import optax
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        clip = optax.clip_by_global_norm(max_norm)
        want_g, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(None))
        got_g = [_t(g.copy()) for g in gs]
        ttrain.clip_by_global_norm_(got_g, max_norm)
        for a, b in zip(got_g, want_g):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
