"""The port's mixed-precision (AMP) training against the JAX package's
``amp=True`` on the CPU, at the TINY configuration of
``tests/test_torch_train_step.py`` (hidden 64, 1+1 layers, 16 queries,
2-frame clips, 128x128 frames), dropout 0:

  - the training dict's dtype plan (every leaf's type equals JAX's);
  - the AMP forward against the port's own fp32 forward (the fractions of the
    JAX package's ``test_amp_forward_close_to_f32``), and the port's AMP
    boxes, classes and loss dict against JAX's, held to a multiple of JAX's
    own AMP-vs-fp32 distance;
  - the AMP gradients of the whole loss against ``jax.value_and_grad`` at
    ``amp=True`` (the port's mapped to the JAX tree), by cosine;
  - one AMP optimizer step against the JAX optimizer on JAX's AMP
    gradients, fp32 masters; three AMP steps lower the loss;
  - the criterion and matcher at ``amp=True`` on fixed decoder outputs
    (the inputs of ``tests/test_torch_criterion.py``), inter-instance
    repulsion on and off;
  - the pieces: the promoting linear, dropout masks drawn alike in bf16 and
    fp32, the fp32-output product, the backward bound's element size.

bf16 rounds at other places in the two frameworks (torch and XLA each round
their own elementwise and norm outputs), and the query selection and the
inter-frame association are argmaxes that a rounding can flip, so the
comparisons are by distance and direction, not elementwise. JAX is compiled
once per program: the AMP loss's value and gradient, the fp32 loss, and the
optimizer update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_criterion as tcr
import test_torch_train_step as tts
from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.losses import CriterionCfg as JCritCfg
from mdqe_cvpr2023_tpu.losses import criterion as jcrit
from mdqe_cvpr2023_tpu.losses import matcher as jmatch
from mdqe_cvpr2023_tpu.models import decoder as jdec
from mdqe_cvpr2023_tpu.models import detr as jdetr
from mdqe_cvpr2023_tpu.parallel import train as jtrain
from mdqe_cvpr2023_tpu_torch.engine.weights import grad_state_dict
from mdqe_cvpr2023_tpu_torch.losses import criterion as tcrit
from mdqe_cvpr2023_tpu_torch.losses import matcher as tmatch
from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
from mdqe_cvpr2023_tpu_torch.models import detr as tdetr
from mdqe_cvpr2023_tpu_torch.parallel import train as ttrain
from mdqe_cvpr2023_tpu_torch.tools import measure
from mdqe_cvpr2023_tpu_torch.utils import nn as tnn

torch.set_num_threads(2)

_t = tts._t


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


@pytest.fixture(scope="module")
def jax_amp():
    """The JAX side: at amp=True the loss dict, the training dict and the
    gradients of the loss composition, and the JAX optimizer's first update
    on those gradients; at fp32 the loss dict and the training dict."""
    params = tts._tree(tts._new_model())
    batch = tts.make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jdetr.MDQEModelCfg(**tts.TINY)
    crit = JCritCfg(**tts.CRIT)
    key = jax.random.PRNGKey(1)
    relpos = jnp.asarray(jdec.query_relpos_grid(4))
    mean, std = jnp.asarray(tts.MEAN, jnp.float32), jnp.asarray(tts.STD, jnp.float32)

    def loss_fn(p, amp):  # make_train_step's loss_fn, dropout 0
        images = (jb["images"].astype(jnp.float32) - mean) / std
        out = jdetr.detr_apply_backbone(p, cfg, images, jb["image_sizes"], n_frames=tts.T,
                                        training=True, drop_rate=0.0,
                                        rng=jax.random.fold_in(key, 999), amp=amp)
        mm, m8 = jtrain.prepare_targets_device(jb["masks"], (tts.HP, tts.WP), 4)
        tg = {"labels": jb["labels"], "ids": jb["ids"], "boxes": jb["boxes"],
              "valid": jb["valid"], "match_masks": mm, "masks8": m8}
        total, ldict = jcrit.criterion_apply(crit, out, tg, relpos, key, amp=amp)
        return total, (ldict, out)

    (total, (ldict, out)), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, True), has_aux=True))(params)
    total32, (ldict32, out32) = jax.jit(lambda p: loss_fn(p, False))(params)
    tx = jtrain.make_optimizer(jtrain.TrainCfg())
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    return {"batch": batch, "priorities": tts.jax_reid_priorities(key, tts.CRIT["n_query"]),
            "total": float(total), "ldict": {k: float(v) for k, v in ldict.items()},
            "out": out, "grads": grads, "total32": float(total32),
            "ldict32": {k: float(v) for k, v in ldict32.items()}, "out32": out32,
            "params1": jax.tree.map(lambda p, u: p + u, params, updates),
            "frozen": jtrain.frozen_leaf_mask(params, 2)}


@pytest.fixture(scope="module")
def port_fwd(jax_amp):
    """The port's training dict at AMP and at fp32 on the same frames."""
    batch = jax_amp["batch"]
    images = (_t(batch["images"]).float() - torch.tensor(tts.MEAN)) / torch.tensor(tts.STD)
    model = tts._new_model()
    with torch.no_grad():
        return {amp: tdetr.detr_apply_backbone(model.detr, images, _t(batch["image_sizes"]),
                                               tts.T, amp=amp) for amp in (True, False)}


@pytest.fixture(scope="module")
def port_grads(jax_amp):
    """The port's losses and gradients at AMP and at fp32: {amp: (model,
    optimizer, total, loss dict)}."""
    out = {}
    for amp in (True, False):
        model = tts._new_model()
        opt = ttrain.make_optimizer(model, ttrain.TrainCfg())
        opt.zero_grad()
        total, ldict = ttrain.loss_fn(model, CriterionCfg(**tts.CRIT),
                                      tts._port_batch(jax_amp["batch"]), dropout_rate=0.0,
                                      reid_priorities=_t(jax_amp["priorities"]), amp=amp)
        total.backward()
        out[amp] = (model, opt, total.item(), {k: v.item() for k, v in ldict.items()})
    return out


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

def test_amp_training_dict_dtypes_match_jax(jax_amp, port_fwd):
    """Every leaf of the AMP training dict has JAX's type: boxes, classes,
    coefficients and the query stream fp32 (the queries are sampled from the
    bf16 encoding with fp32 weights, and JAX promotes from there), the proto
    features and the rpn logits bf16."""
    want = dict(_leaves(jax_amp["out"]))
    got = dict(_leaves(port_fwd[True]))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert str(v.dtype)[len("torch."):] == str(want[k].dtype), k
        assert tuple(v.shape) == tuple(want[k].shape), k
    assert got["boxes"].dtype == torch.float32 and got["proto"].dtype == torch.bfloat16


def test_amp_forward_close_to_f32(port_fwd):
    """The port's AMP forward tracks its fp32 forward by the fractions the JAX
    package holds its own to (tests/test_train_step.py::
    test_amp_forward_close_to_f32): more than 85% of the box coordinates
    within 0.05, more than 85% of the class logits within 0.35, their median
    below 0.05. Argmax decisions (per-cell query peaks, inter-frame
    association) can flip under bf16 and replace a query wholesale."""
    amp, f32 = port_fwd[True], port_fwd[False]
    db = (amp["boxes"] - f32["boxes"]).abs()
    dc = (amp["cls"] - f32["cls"]).abs()
    assert float((db < 0.05).float().mean()) > 0.85
    assert float((dc < 0.35).float().mean()) > 0.85
    assert float(dc.median()) < 0.05


def test_amp_forward_and_losses_within_jax_own_amp_distance(jax_amp, port_fwd, port_grads):
    """The port's AMP lies no farther from JAX's AMP than a stated multiple of
    JAX's own AMP-vs-fp32 distance (RMS over the entries): boxes 2x
    (measured 1.61x: a few flipped queries decide both), classes 0.9x
    (measured 0.67x); the loss dict as a vector (every weighted loss) 0.5x
    (measured 0.26x), and the total within 1e-2 relative (measured 2.2e-3).
    The port's fp32 equals JAX's fp32 (tests/test_torch_train_step.py), so a
    port whose AMP ran in fp32 would read 1x on classes and the loss dict,
    and fail both."""
    j_amp, j32 = jax_amp["out"], jax_amp["out32"]
    for k, mult in (("boxes", 2.0), ("cls", 0.9)):
        got = port_fwd[True][k].float().numpy()
        want = np.asarray(j_amp[k], np.float32)
        own = _rms(want - np.asarray(j32[k], np.float32))
        assert own > 0, k
        assert _rms(got - want) <= mult * own, (k, _rms(got - want) / own)
    ld = port_grads[True][3]
    keys = sorted(jax_amp["ldict"])
    assert sorted(ld) == keys
    got = np.array([ld[k] for k in keys])
    want = np.array([jax_amp["ldict"][k] for k in keys])
    own = np.linalg.norm(want - np.array([jax_amp["ldict32"][k] for k in keys]))
    assert np.linalg.norm(got - want) <= 0.5 * own, np.linalg.norm(got - want) / own
    np.testing.assert_allclose(port_grads[True][2], jax_amp["total"], rtol=1e-2)


# --------------------------------------------------------------------------
# gradients and steps
# --------------------------------------------------------------------------

def test_amp_gradients_point_as_jax_amp_gradients(jax_amp, port_grads):
    """The AMP gradients of the whole loss against JAX's AMP gradients, over
    the trainable leaves: overall cosine >= 0.95 (measured 0.968) and no lower
    than the port's fp32 gradients' cosine to JAX's AMP ones (0.914): the AMP
    path rounds where JAX rounds. Per leaf, cosine >= 0.85 (measured 0.886 at
    least, deep backbone convolutions) where the leaf's largest JAX gradient
    is above 1e-2 of the model's largest and its fp32 gradient is not zero
    up to rounding (below 1e-4 of the model's largest fp32 gradient: the
    biases before a GroupNorm and the shift-invariant time-weight bias,
    whose bf16 gradients are rounding noise of either sign)."""
    def flat(model):
        return convert_torch_state_dict(grad_state_dict(model))
    amp = jax.tree_util.tree_leaves(flat(port_grads[True][0]))
    f32 = jax.tree_util.tree_leaves(flat(port_grads[False][0]))
    paths = jax.tree_util.tree_flatten_with_path(jax_amp["grads"])[0]
    frozen = jax.tree_util.tree_leaves(jax_amp["frozen"])
    assert len(amp) == len(f32) == len(paths) == len(frozen)
    rows = [(jax.tree_util.keystr(kp), np.asarray(a, np.float64).ravel(),
             np.asarray(b, np.float64).ravel(), np.asarray(j, np.float64).ravel())
            for (kp, j), a, b, f in zip(paths, amp, f32, frozen) if not f]
    assert len(rows) > 100

    def cos(x, y):
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    a_all, b_all, j_all = (np.concatenate([r[i] for r in rows]) for i in (1, 2, 3))
    overall, overall32 = cos(a_all, j_all), cos(b_all, j_all)
    assert overall >= 0.95 and overall >= overall32, (overall, overall32)
    G = max(np.abs(r[3]).max() for r in rows)
    G32 = max(np.abs(r[2]).max() for r in rows)
    checked = 0
    for path, a, b, j in rows:
        if np.abs(j).max() > 1e-2 * G and np.abs(b).max() > 1e-4 * G32:
            assert cos(a, j) >= 0.85, (path, cos(a, j))
            checked += 1
    assert checked > 50


def test_amp_step_keeps_fp32_masters_and_tracks_jax(jax_amp, port_grads):
    """One AMP optimizer step (TrainCfg(): lr 1e-4, clip 0.01): parameters,
    gradients and AdamW's moments stay fp32; frozen leaves equal JAX's
    (unchanged); against the JAX optimizer applied to JAX's AMP gradients,
    90% of the trainable entries within 0.05 lr and 99% within 0.5 lr, all
    within 2.1 lr. Adam's first step is about lr * sign(g), so an entry whose
    gradient changes sign between the two frameworks' bf16 roundings moves
    up to 2 lr apart (measured: q90 0.023 lr, q99 0.195 lr, max 1.998 lr)."""
    model, opt = port_grads[True][:2]
    opt.step()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in opt.params)
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.adamw.state.values())
    lr = ttrain.TrainCfg().base_lr
    diffs = tts._param_diffs(model, jax_amp["params1"], jax_amp["frozen"])
    d = np.concatenate([x.ravel() for x, _ in diffs.values()]) / lr
    q90, q99 = np.quantile(d, [0.9, 0.99])
    assert q90 <= 0.05 and q99 <= 0.5 and d.max() <= 2.1, (q90, q99, d.max())


def test_amp_steps_lower_the_loss_and_keep_frozen_leaves():
    """The JAX package's AMP check (tests/test_train_step.py::
    test_train_step_amp_decreases_loss: lr 1e-3, clip 1.0, dropout 0.1) on
    the port: three AMP steps on a fixed batch give finite, falling losses,
    parameters stay fp32 and every frozen parameter and buffer stays
    bit-identical."""
    model = tts._new_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ttrain.make_optimizer(model, ttrain.TrainCfg(base_lr=1e-3, steps=(1000,),
                                                       clip_norm=1.0, amp=True))
    step = ttrain.make_train_step(CriterionCfg(**tts.CRIT), amp=True)
    batch = tts._port_batch(tts.make_batch(seed=4))
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(model, opt, batch, gen)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(v.dtype == before[k].dtype for k, v in model.state_dict().items())
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    for k, v in model.state_dict().items():
        if k not in trainable:
            assert torch.equal(v, before[k]), k


# --------------------------------------------------------------------------
# criterion and matcher
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crit_data():
    """tests/test_torch_criterion.py's targets and decoder outputs, in the
    AMP training dict's types (proto and rpn logits bf16)."""
    tg = tcr.make_targets()
    mm, m8 = ttrain.prepare_targets_device(_t(tg["masks"]), (tcr.HP, tcr.WP), 4)
    port_tg = {"labels": _t(tg["labels"]), "ids": _t(tg["ids"]), "boxes": _t(tg["boxes"]),
               "valid": _t(tg["valid"]), "match_masks": mm, "masks8": m8}
    jmm, jm8 = jtrain.prepare_targets_device(jnp.asarray(tg["masks"]), (tcr.HP, tcr.WP), 4)
    jax_tg = {"labels": jnp.asarray(tg["labels"]), "ids": jnp.asarray(tg["ids"]),
              "boxes": jnp.asarray(tg["boxes"]), "valid": jnp.asarray(tg["valid"]),
              "match_masks": jmm, "masks8": jm8}
    return tcr.make_outputs(), port_tg, jax_tg


BF16_INPUTS = ("proto", "rpn_sem_cls")


@pytest.mark.parametrize("interinst", [True, False])
def test_amp_criterion_matches_jax(crit_data, interinst):
    """criterion_apply(amp=True) against JAX's on the same decoder outputs
    (proto and rpn logits bf16, as the AMP forward gives them): every loss
    within 5e-4 relative (measured 6.3e-5: the two frameworks round softplus
    and sigmoid of the bf16 mask logits on their own and sum in another
    order), the total within 1e-4 (5.6e-6); gradients with respect to each
    output within 2e-2 of its largest entry (1.1e-2: the bf16 gradients of
    proto and the coefficients round within a few bf16 steps of each other)
    and cosine >= 0.9999 (0.99998). The amp losses differ from the fp32 ones
    (the check that amp took effect)."""
    outputs, port_tg, jax_tg = crit_data
    cfg_kw = dict(num_classes=tcr.K, n_frames=tcr.T, n_query=tcr.Q, num_points=64,
                  interinst_enabled=interinst)
    key = jax.random.PRNGKey(7)
    relpos = jdec.query_relpos_grid(4)
    grid = outputs["query_init"]["query_coords_grid"]
    names = ("cls", "boxes", "mask_coeff", "proto", "rpn_sem_cls", "query_init_embed")
    arrays = [outputs[k] for k in names[:4]] + [outputs["query_init"][k] for k in names[4:]]
    dtypes = [jnp.bfloat16 if n in BF16_INPUTS else jnp.float32 for n in names]
    jargs = [jnp.asarray(a, dt) for a, dt in zip(arrays, dtypes)]

    def jax_total(cls, boxes, coeff, proto, rpn, emb):
        out = {"cls": cls, "boxes": boxes, "mask_coeff": coeff, "proto": proto,
               "query_init": {"rpn_sem_cls": rpn, "query_init_embed": emb,
                              "query_coords_grid": jnp.asarray(grid)}}
        return jcrit.criterion_apply(jcrit.CriterionCfg(**cfg_kw), out, jax_tg,
                                     jnp.asarray(relpos), key, amp=True)
    (jtotal, jld), jgrads = jax.value_and_grad(jax_total, argnums=tuple(range(6)),
                                               has_aux=True)(*jargs)

    def port(amp):
        leaves = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16 if n in BF16_INPUTS else torch.float32).requires_grad_(True)
                  for n, a in zip(names, jargs)]
        out = dict(zip(names[:4], leaves[:4]))
        out["query_init"] = {"rpn_sem_cls": leaves[4], "query_init_embed": leaves[5],
                             "query_coords_grid": _t(grid)}
        total, ld = tcrit.criterion_apply(
            tcrit.CriterionCfg(**cfg_kw), out, port_tg, _t(relpos),
            reid_priorities=_t(tcr.jax_reid_priorities(key)), amp=amp)
        return total, ld, torch.autograd.grad(total, leaves)
    total, ld, grads = port(True)
    total32, ld32, _ = port(False)
    assert sorted(ld) == sorted(jld)
    for k in jld:
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=5e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    assert any(abs(ld[k].item() - ld32[k].item()) > 1e-6 * abs(ld32[k].item())
               for k in ld if "mask" in k or "dice" in k)
    for name, g, w in zip(names, grads, jgrads):
        g = g.float().numpy().astype(np.float64).ravel()
        w = np.asarray(w.astype(jnp.float32), np.float64).ravel()
        assert str(grads[names.index(name)].dtype) == ("torch.bfloat16" if name in BF16_INPUTS
                                                       else "torch.float32"), name
        assert np.abs(w).max() > 0, name
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999, name


def test_amp_matcher_costs_match_jax(crit_data):
    """The mask costs and the cost assembly at compute_dtype bfloat16 against
    JAX's (vmapped over the videos): the mask costs within 1e-4 plus 2e-3
    relative and the assembled cost within 1e-2 of its largest finite
    magnitude plus 2e-3 relative (measured 1.5e-4 on costs of magnitude 1:
    bf16 elementwise rounding, fp32 sums), and the assignment they give the
    same."""
    outputs, port_tg, jax_tg = crit_data
    rng = np.random.default_rng(4)
    B, Q, N, T = tcr.B, tcr.Q, tcr.N, tcr.T
    out_masks = (rng.standard_normal((B, Q, T, tcr.HP // 4, tcr.WP // 4)) * 3).astype(
        np.float32)
    om = _t(out_masks).bfloat16()
    jom = jnp.asarray(out_masks, jnp.bfloat16)
    tm = port_tg["match_masks"].reshape(B, N, -1)
    jtm = jax_tg["match_masks"].reshape(B, N, -1)
    for tfn, jfn in ((tmatch.batch_dice_cost, jmatch.batch_dice_cost),
                     (tmatch.batch_sigmoid_ce_cost, jmatch.batch_sigmoid_ce_cost)):
        got = tfn(om.reshape(B, Q, -1), tm, torch.bfloat16)
        want = np.asarray(jax.vmap(lambda a, b: jfn(a, b, jnp.bfloat16))(
            jom.reshape(B, Q, -1), jtm))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-4)
    prob = 1 / (1 + np.exp(-outputs["cls"][-1]))
    boxes = outputs["boxes"][-1]
    cost, giou = tmatch.hungarian_match_costs(
        _t(prob), _t(boxes), om, port_tg["labels"], port_tg["boxes"],
        port_tg["match_masks"], port_tg["valid"], compute_dtype=torch.bfloat16)
    jcost, jgiou = jax.vmap(lambda *a: jmatch.hungarian_match_costs(
        *a, compute_dtype=jnp.bfloat16))(prob, boxes, jom, jax_tg["labels"],
                                          jax_tg["boxes"], jax_tg["match_masks"],
                                          jax_tg["valid"])
    jcost = np.asarray(jcost)
    np.testing.assert_allclose(cost.numpy(), jcost, rtol=2e-3,
                               atol=1e-2 * np.abs(jcost[jcost < 1e3]).max())
    np.testing.assert_array_equal(
        tmatch.dynamic_k_matching(cost, giou, port_tg["valid"]).numpy(),
        np.asarray(jax.vmap(jmatch.dynamic_k_matching)(jcost, jgiou, jax_tg["valid"])))


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def test_linear_promotes_as_jax_einsum():
    """``utils.nn.linear`` computes in the promoted type of input and weight,
    as the JAX package's ``linear`` (a jnp.einsum plus bias) does: an fp32
    input with bf16 weights gives the fp32 product of the upcast weights,
    bf16 with bf16 stays bf16, and fp32 with fp32 equals F.linear."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    w = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    wb, bb = _t(w).bfloat16(), _t(b).bfloat16()
    got = tnn.linear(_t(x), wb, bb)
    want = jnp.einsum("...i,oi->...o", jnp.asarray(x), jnp.asarray(w, jnp.bfloat16)) \
        + jnp.asarray(b, jnp.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tnn.linear(_t(x).bfloat16(), wb, bb).dtype == torch.bfloat16
    torch.testing.assert_close(tnn.linear(_t(x), _t(w), _t(b)),
                               torch.nn.functional.linear(_t(x), _t(w), _t(b)), rtol=0, atol=0)
    lin = tnn.Linear(8, 6)
    assert isinstance(lin, torch.nn.Linear) and lin(_t(x)).dtype == torch.float32


@pytest.mark.parametrize("fn", [tnn.dropout, tnn.drop_path])
def test_dropout_masks_alike_in_bf16_and_fp32(fn):
    """The same generator state drops the same entries (or samples) of a bf16
    and an fp32 activation, as jax.random.bernoulli draws one mask whatever
    the activation's type, and the kept bf16 entries are x / (1 - rate)
    rounded once."""
    x = torch.rand(40, 6, 50) + 0.5
    a = fn(x, 0.3, torch.Generator().manual_seed(3))
    b = fn(x.bfloat16(), 0.3, torch.Generator().manual_seed(3))
    assert b.dtype == torch.bfloat16
    assert torch.equal(a == 0, b == 0) and bool((a == 0).any())
    torch.testing.assert_close(b, (x.bfloat16() / 0.7).where(a != 0, torch.zeros(())).bfloat16(),
                               rtol=0, atol=0)


def test_matmul_f32_sums_bf16_products_in_fp32():
    """``matmul_f32`` of bf16 operands: the exact products summed in fp32
    (against f64 of the same bf16 values), not rounded to bf16; its
    gradients are the fp32 output gradient times the other operand upcast,
    cast to the operand's type (JAX's transpose rule)."""
    rng = np.random.default_rng(1)
    a = _t(rng.standard_normal((2, 7, 300)).astype(np.float32)).bfloat16().requires_grad_(True)
    b = _t(rng.standard_normal((2, 300, 5)).astype(np.float32)).bfloat16().requires_grad_(True)
    out = tmatch.matmul_f32(a, b)
    want = a.double() @ b.double()
    assert out.dtype == torch.float32
    assert float((out.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((torch.matmul(a, b).double() - want).abs().max()) > float(
        (out.double() - want).abs().max())  # a bf16 output would round
    g = _t(rng.standard_normal((2, 7, 5)).astype(np.float32))
    ga, gb = torch.autograd.grad(out, (a, b), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga, (g @ b.float().transpose(1, 2)).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(gb, (a.float().transpose(1, 2) @ g).bfloat16(), rtol=0, atol=0)


def test_backward_bound_counts_the_value_type():
    """``measure.msda_bwd_bound`` counts the value rows read and d(value)
    written at the value's element size: a bf16 value saves 2 bytes an
    element of each, fp32 counts 4 as before."""
    rng = np.random.default_rng(2)
    shapes = ((6, 8), (3, 4))
    v = _t(rng.standard_normal((1, 60, 2, 32)).astype(np.float32))
    loc = _t(rng.uniform(0, 1, (1, 5, 2, 2, 4, 2)).astype(np.float32))
    attw = torch.full((1, 5, 2, 2, 4), 1 / 8)
    _, _, b32, atom32 = measure.msda_bwd_bound(v, shapes, loc, attw)
    _, _, b16, atom16 = measure.msda_bwd_bound(v.bfloat16(), shapes, loc, attw)
    touched, taps = measure.msda_taps(v, shapes, loc)
    fixed = 2 * loc.numel() * 4 + 2 * attw.numel() * 4 + 5 * 2 * 32 * 4
    assert b32 == touched * 32 * 4 + v.numel() * 4 + fixed
    assert b16 == touched * 32 * 2 + v.numel() * 2 + fixed
    assert atom32 == atom16 == taps * 32 // 4
