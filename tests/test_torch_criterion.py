"""The port's matcher and criterion against the JAX package on the CPU, fp32 on
both sides: the box IoU family, nearest grid sampling, the target transforms,
every matcher function (the JAX ones vmapped over the videos), the criterion's
losses with the inter-instance repulsion on and off, and the gradients of the
total loss with respect to the decoder outputs against ``jax.grad``. The reid
priorities are the draws the JAX criterion makes from its key.

Inputs are made with numpy from a seed: 2 clips of 2 frames, 16 queries, 5
classes, 3 decoder layers (L + 1), 4 instance slots of which 3 and 2 are
valid, 64x96 frames (stride-4 masks 16x24, stride-8 map 8x12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdqe_cvpr2023_tpu.losses import criterion as jcrit
from mdqe_cvpr2023_tpu.losses import matcher as jmatch
from mdqe_cvpr2023_tpu.models.decoder import query_relpos_grid
from mdqe_cvpr2023_tpu.parallel.train import prepare_targets_device as j_prepare
from mdqe_cvpr2023_tpu.utils import boxes as jboxes
from mdqe_cvpr2023_tpu.utils import misc as jmisc
from mdqe_cvpr2023_tpu_torch.losses import criterion as tcrit
from mdqe_cvpr2023_tpu_torch.losses import matcher as tmatch
from mdqe_cvpr2023_tpu_torch.parallel.train import prepare_targets_device as t_prepare
from mdqe_cvpr2023_tpu_torch.utils import boxes as tboxes
from mdqe_cvpr2023_tpu_torch.utils import misc as tmisc

torch.set_num_threads(2)

B, T, Q, K, M, E, L1, N = 2, 2, 16, 5, 8, 8, 3, 4
HP, WP = 64, 96
H8, W8 = 8, 12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _xyxy(cxcywh):
    c, wh = cxcywh[..., :2], cxcywh[..., 2:]
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def make_targets(seed=0):
    """Rectangles with their own box in every frame; slots 0-2 valid in clip
    0, 0-1 in clip 1; instance 1 of clip 0 has no pixels in frame 1 (its
    nearest pixel is claimed instead)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, N, T, HP, WP), np.float32)
    boxes = np.zeros((B, N, T, 4), np.float32)
    ids = np.full((B, N, T), -1, np.int32)
    valid = np.zeros((B, N), bool)
    for b, n_valid in enumerate((3, 2)):
        for n in range(n_valid):
            for t in range(T):
                x0 = rng.integers(0, WP // 2)
                y0 = rng.integers(0, HP // 2)
                w, h = rng.integers(12, 40), rng.integers(10, 30)
                boxes[b, n, t] = [x0 / WP, y0 / HP, min(x0 + w, WP) / WP,
                                  min(y0 + h, HP) / HP]
                if not (b == 0 and n == 1 and t == 1):
                    masks[b, n, t, y0:y0 + h, x0:x0 + w] = 1.0
            ids[b, n] = n
            valid[b, n] = True
    labels = rng.integers(0, K, (B, N)).astype(np.int32)
    return {"labels": labels, "ids": ids, "boxes": boxes, "masks": masks, "valid": valid}


def make_outputs(seed=1):
    rng = np.random.default_rng(seed)
    cxcywh = np.concatenate([rng.uniform(0.15, 0.85, (L1, B, Q, T, 2)),
                             rng.uniform(0.08, 0.5, (L1, B, Q, T, 2))], -1)
    return {
        "cls": (rng.standard_normal((L1, B, Q, K)) * 2).astype(np.float32),
        "boxes": _xyxy(cxcywh),
        "mask_coeff": np.tanh(rng.standard_normal((L1, B, Q, M))).astype(np.float32),
        "proto": rng.standard_normal((B * T, HP // 4, WP // 4, M)).astype(np.float32),
        "query_init": {
            "rpn_sem_cls": rng.standard_normal((B * T, H8, W8, K)).astype(np.float32),
            "query_init_embed": rng.standard_normal((B * T, Q, E)).astype(np.float32),
            "query_coords_grid": rng.uniform(-1, 1, (B * T, 4, 4, 2)).astype(np.float32),
        },
    }


def jax_reid_priorities(key):
    out = np.zeros((B, N, 2, T * Q))
    for b, kb in enumerate(jax.random.split(key, B)):
        for n, kn in enumerate(jax.random.split(kb, N)):
            k1, k2 = jax.random.split(kn)
            out[b, n, 0] = np.asarray(jax.random.uniform(k1, (T * Q,)))
            out[b, n, 1] = np.asarray(jax.random.uniform(k2, (T * Q,)))
    return out


@pytest.fixture(scope="module")
def data():
    tg = make_targets()
    mm, m8 = t_prepare(_t(tg["masks"]), (HP, WP), 4)
    port_tg = {"labels": _t(tg["labels"]), "ids": _t(tg["ids"]), "boxes": _t(tg["boxes"]),
               "valid": _t(tg["valid"]), "match_masks": mm, "masks8": m8}
    jmm, jm8 = j_prepare(jnp.asarray(tg["masks"]), (HP, WP), 4)
    jax_tg = {"labels": jnp.asarray(tg["labels"]), "ids": jnp.asarray(tg["ids"]),
              "boxes": jnp.asarray(tg["boxes"]), "valid": jnp.asarray(tg["valid"]),
              "match_masks": jmm, "masks8": jm8}
    return make_outputs(), port_tg, jax_tg


def test_prepare_targets_matches_jax(data):
    _, port_tg, jax_tg = data
    np.testing.assert_allclose(port_tg["match_masks"].numpy(),
                               np.asarray(jax_tg["match_masks"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port_tg["masks8"].numpy(), np.asarray(jax_tg["masks8"]))
    assert port_tg["masks8"].shape == (B, N, T, H8 * W8)


def test_box_iou_family_matches_jax():
    rng = np.random.default_rng(2)
    b1 = _xyxy(np.concatenate([rng.uniform(0.2, 0.8, (5, 3, 2)),
                               rng.uniform(0.05, 0.5, (5, 3, 2))], -1))
    b2 = _xyxy(np.concatenate([rng.uniform(0.2, 0.8, (4, 3, 2)),
                               rng.uniform(0.0, 0.5, (4, 3, 2))], -1))
    valid = rng.random((4, 3)) > 0.3
    for got, want in [
            (tboxes.box_iou(_t(b1[:, 0]), _t(b2[:, 0])),
             jboxes.box_iou(jnp.asarray(b1[:, 0]), jnp.asarray(b2[:, 0]))),
            ((tboxes.generalized_box_iou(_t(b1[:, 0]), _t(b2[:, 0])),),
             (jboxes.generalized_box_iou(jnp.asarray(b1[:, 0]), jnp.asarray(b2[:, 0])),)),
            (tboxes.video_box_iou(_t(b1), _t(b2)),
             jboxes.video_box_iou(jnp.asarray(b1), jnp.asarray(b2))),
            ((tboxes.video_generalized_box_iou(_t(b1), _t(b2)),
              tboxes.video_generalized_box_iou(_t(b1), _t(b2), _t(valid))),
             (jboxes.video_generalized_box_iou(jnp.asarray(b1), jnp.asarray(b2)),
              jboxes.video_generalized_box_iou(jnp.asarray(b1), jnp.asarray(b2),
                                               jnp.asarray(valid))))]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # leading batch axes
    batched = tboxes.video_box_iou(_t(np.stack([b1, b1])), _t(np.stack([b2, b2])))[0]
    np.testing.assert_array_equal(batched[1].numpy(),
                                  tboxes.video_box_iou(_t(b1), _t(b2))[0].numpy())


@pytest.mark.parametrize("extent", [1.0, 1.3])
def test_grid_sample_nearest_matches_jax_and_torch(extent):
    """Nearest with border padding (the criterion's query-id lookup) rounds
    half to even in all three, inside the image and beyond its edge."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-extent, extent, (2, 4, 6, 2)).astype(np.float32)
    grid[0, 0, 0] = [-7 / 9, 3 / 7]  # pixel coordinates 0.5, 4.0: a tie in x
    got = tmisc.grid_sample(_t(img), _t(grid), "border", mode="nearest")
    want = jmisc.grid_sample(jnp.asarray(img), jnp.asarray(grid), "border",
                             mode="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = F.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid), mode="nearest",
                           padding_mode="border", align_corners=False)
    np.testing.assert_array_equal(got.numpy(), oracle.permute(0, 2, 3, 1).numpy())


def test_grid_sample_nearest_rejects_zeros_padding():
    with pytest.raises(ValueError):
        tmisc.grid_sample(torch.zeros(1, 2, 2, 1), torch.zeros(1, 1, 1, 2), "zeros",
                          mode="nearest")


def _vmapped(fn, *args, **kw):
    return jax.vmap(lambda *a: fn(*a, **kw))(*[jnp.asarray(a) for a in args])


def test_matcher_functions_match_jax(data):
    outputs, port_tg, jax_tg = data
    rng = np.random.default_rng(4)
    out_masks = rng.standard_normal((B, Q, T, HP // 4, WP // 4)).astype(np.float32) * 3
    prob = 1 / (1 + np.exp(-outputs["cls"][-1]))
    boxes = outputs["boxes"][-1]
    tm = port_tg["match_masks"].numpy()
    om_flat, tm_flat = out_masks.reshape(B, Q, -1), tm.reshape(B, N, -1)

    for tfn, jfn in ((tmatch.batch_dice_cost, jmatch.batch_dice_cost),
                     (tmatch.batch_sigmoid_ce_cost, jmatch.batch_sigmoid_ce_cost)):
        np.testing.assert_allclose(tfn(_t(om_flat), _t(tm_flat)).numpy(),
                                   np.asarray(_vmapped(jfn, om_flat, tm_flat)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tmatch.get_in_boxes_info(_t(boxes), port_tg["boxes"]).numpy(),
        np.asarray(_vmapped(jmatch.get_in_boxes_info, boxes, jax_tg["boxes"])))

    cost, giou = tmatch.hungarian_match_costs(
        _t(prob), _t(boxes), _t(out_masks), port_tg["labels"], port_tg["boxes"],
        port_tg["match_masks"], port_tg["valid"])
    jcost, jgiou = _vmapped(jmatch.hungarian_match_costs, prob, boxes, out_masks,
                            jax_tg["labels"], jax_tg["boxes"], jax_tg["match_masks"],
                            jax_tg["valid"])
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(giou.numpy(), np.asarray(jgiou), rtol=0, atol=1e-6)

    # the assignment exactly, on the costs above and on costs full of ties
    # (stable sorts and first-occurrence argmin decide those)
    tied = np.round(np.asarray(jcost) / 40.0).astype(np.float32)
    for c in (np.asarray(jcost), tied):
        got = tmatch.dynamic_k_matching(_t(c), _t(np.asarray(jgiou)), port_tg["valid"])
        want = _vmapped(jmatch.dynamic_k_matching, c, jgiou, jax_tg["valid"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.sum(-1).max() <= 1 and got.sum() >= 3

    from mdqe_cvpr2023_tpu.utils.misc import make_reference_points
    ref = make_reference_points((H8, W8))
    labels, wts, ids = tmatch.clip_peak_match(
        port_tg["labels"], port_tg["boxes"], port_tg["ids"], port_tg["masks8"],
        port_tg["valid"], tmisc.make_reference_points((H8, W8), "cpu"), K)
    jl, jw, ji = jax.vmap(lambda *a: jmatch.clip_peak_match(*a, ref, K))(
        jax_tg["labels"], jax_tg["boxes"], jax_tg["ids"], jax_tg["masks8"],
        jax_tg["valid"])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(wts.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert (labels >= 0).any() and (wts > 0).any()


def _criterion_pair(data, interinst, priorities=None):
    outputs, port_tg, jax_tg = data
    cfg_kw = dict(num_classes=K, n_frames=T, n_query=Q, num_points=64,
                  interinst_enabled=interinst)
    key = jax.random.PRNGKey(7)
    relpos = query_relpos_grid(4)
    if priorities is None:
        priorities = jax_reid_priorities(key)

    def jax_total(cls, boxes, coeff, proto, rpn, emb):
        out = {"cls": cls, "boxes": boxes, "mask_coeff": coeff, "proto": proto,
               "query_init": {"rpn_sem_cls": rpn, "query_init_embed": emb,
                              "query_coords_grid": jnp.asarray(
                                  outputs["query_init"]["query_coords_grid"])}}
        return jcrit.criterion_apply(jcrit.CriterionCfg(**cfg_kw), out, jax_tg,
                                     jnp.asarray(relpos), key)

    names = ("cls", "boxes", "mask_coeff", "proto")
    jargs = [jnp.asarray(outputs[k]) for k in names] + [
        jnp.asarray(outputs["query_init"][k]) for k in ("rpn_sem_cls", "query_init_embed")]
    (jtotal, jld), jgrads = jax.value_and_grad(jax_total, argnums=tuple(range(6)),
                                               has_aux=True)(*jargs)

    leaves = [_t(np.asarray(a)).requires_grad_(True) for a in jargs]
    out = dict(zip(names, leaves[:4]))
    out["query_init"] = {"rpn_sem_cls": leaves[4], "query_init_embed": leaves[5],
                         "query_coords_grid": _t(outputs["query_init"]["query_coords_grid"])}
    total, ld = tcrit.criterion_apply(tcrit.CriterionCfg(**cfg_kw), out, port_tg,
                                      _t(relpos), reid_priorities=_t(priorities))
    grads = torch.autograd.grad(total, leaves)
    return (total, ld, grads), (jtotal, jld, jgrads)


@pytest.mark.parametrize("interinst", [True, False])
def test_criterion_losses_and_grads_match_jax(data, interinst):
    """Losses: rtol 1e-4. Gradients of the total with respect to each decoder
    output: 1e-4 of that output's largest gradient (the matched losses divide
    by the match count and sum (Q, THW) x (THW, N) products in another
    order)."""
    (total, ld, grads), (jtotal, jld, jgrads) = _criterion_pair(data, interinst)
    assert sorted(ld) == sorted(jld)
    assert len(ld) == 3 + 5 * L1
    for k in jld:
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    assert float(jld["loss_reid_query_init"]) > 0  # the reid loss took part
    for name, g, w in zip(("cls", "boxes", "mask_coeff", "proto", "rpn_sem_cls",
                           "query_init_embed"), grads, jgrads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_reid_loss_matches_jax_where_sampling_selects():
    """The contrastive reid loss at 64 queries (T*Q = 128 candidates, caps of
    100 negatives and 20 positives) with instances large enough that the caps
    bite, so the priorities decide the candidates: sums and the gradient with
    respect to the embeddings against the JAX per-video loss vmapped over the
    clips with the same key (1e-5 relative). Other priorities give another
    loss."""
    Qb, Nb = 64, 3
    rng = np.random.default_rng(5)
    emb = (rng.standard_normal((B, T, Qb, E)) * 0.5).astype(np.float32)
    emb[0, 0, 5] = 0.0  # a zero embedding row: finite gradient
    q_ids = rng.choice([-1, 0, 1, 2], p=[0.2, 0.45, 0.25, 0.1],
                       size=(B, T, Qb)).astype(np.int32)
    gt_ids = np.tile(np.arange(Nb)[None, :, None], (B, 1, T)).astype(np.int32)
    gt_ids[1, 2] = -1
    gt_valid = np.array([[True, True, True], [True, True, False]])
    relpos = query_relpos_grid(8)
    cfg = dict(num_classes=K, n_frames=T, n_query=Qb)
    key = jax.random.PRNGKey(3)
    pri = np.zeros((B, Nb, 2, T * Qb))
    for b, kb in enumerate(jax.random.split(key, B)):
        for n, kn in enumerate(jax.random.split(kb, Nb)):
            k1, k2 = jax.random.split(kn)
            pri[b, n, 0] = np.asarray(jax.random.uniform(k1, (T * Qb,)))
            pri[b, n, 1] = np.asarray(jax.random.uniform(k2, (T * Qb,)))

    def jax_sums(e):
        ctt, aux, cnt = jax.vmap(lambda ev, qi, gi, gv, r: jcrit._reid_loss_video(
            jcrit.CriterionCfg(**cfg), ev, qi, gi, gv, jnp.asarray(relpos), r))(
            e, jnp.asarray(q_ids), jnp.asarray(gt_ids), jnp.asarray(gt_valid),
            jax.random.split(key, B))
        return ctt.sum() + aux.sum(), (ctt.sum(), aux.sum(), cnt.sum())

    (_, want), jgrad = jax.value_and_grad(jax_sums, has_aux=True)(jnp.asarray(emb))
    e = _t(emb).requires_grad_(True)

    def port(p):
        return tcrit.reid_losses(tcrit.CriterionCfg(**cfg), e, _t(q_ids).long(),
                                 _t(gt_ids).long(), _t(gt_valid), _t(relpos), _t(p))

    got = port(pri)
    (grad,) = torch.autograd.grad(got[0] + got[1], e)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    assert float(want[2]) == 5 and float(want[0]) > 0
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())
    assert torch.isfinite(grad).all()
    other = port(pri[..., ::-1].copy())
    assert other[0].item() != got[0].item()


def test_reid_loss_needs_priorities_or_a_generator(data):
    outputs, port_tg, _ = data
    out = {k: _t(outputs[k]) for k in ("cls", "boxes", "mask_coeff", "proto")}
    out["query_init"] = {k: _t(v) for k, v in outputs["query_init"].items()}
    with pytest.raises(ValueError):
        tcrit.criterion_apply(tcrit.CriterionCfg(num_classes=K, n_frames=T, n_query=Q),
                              out, port_tg, _t(query_relpos_grid(4)))
    total, _ = tcrit.criterion_apply(
        tcrit.CriterionCfg(num_classes=K, n_frames=T, n_query=Q, num_points=64), out,
        port_tg, _t(query_relpos_grid(4)), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(total)


def test_top_k_breaks_ties_as_jax():
    x = np.array([[0.5, 0.2, 0.5, -np.inf, 0.2, -np.inf, 0.9]], np.float32)
    vals, idx = tcrit.top_k(_t(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
