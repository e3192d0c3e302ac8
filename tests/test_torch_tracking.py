"""The port's clip post-processing, exact assignment, device tracker, mask
finalize and video merge against the JAX package's, on the CPU, with inputs
made by numpy from a seed. The assignment must give the same columns (ties
included); float results agree to 1e-5 (the same fp32 expressions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.models import meta as jmeta
from mdqe_cvpr2023_tpu.ops.hungarian import lsa_maximize as jax_lsa_maximize
from mdqe_cvpr2023_tpu.tracking import device_tracker as jtr
from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
from mdqe_cvpr2023_tpu_torch.ops.hungarian import lsa_maximize
from mdqe_cvpr2023_tpu_torch.tracking import device_tracker as ttr

torch.set_num_threads(2)


@pytest.mark.parametrize("T", [2, 6])
def test_postprocess_clip_matches_jax(T):
    """Batched over S clips in the port, one clip at a time in JAX."""
    rng = np.random.default_rng(T)
    S, Q, K, M, C, H, W, topk = 2, 24, 5, 8, 16, 12, 14, 10
    cls = rng.uniform(0, 0.5, (S, Q, K)).astype(np.float32)
    coeff = np.tanh(rng.standard_normal((S, Q, M))).astype(np.float32)
    emb = rng.standard_normal((S, Q, C)).astype(np.float32)
    emb[:, 5] = emb[:, 3] * 1.001      # near-duplicates for the 0.99 dedup
    coeff[:, 7] = coeff[:, 2]          # overlapping masks for the NMS
    feats = rng.standard_normal((S, T, H, W, M)).astype(np.float32)
    got = tmeta.postprocess_clip(*(torch.from_numpy(a) for a in (cls, coeff, emb, feats)),
                                 0.1, topk)
    for s in range(S):
        want = jmeta.postprocess_clip(jnp.asarray(cls[s]), jnp.asarray(coeff[s]),
                                      jnp.asarray(emb[s]), jnp.asarray(feats[s]), 0.1,
                                      topk)
        for key in ("classes", "valid"):
            np.testing.assert_array_equal(got[key][s].numpy(), np.asarray(want[key]),
                                          err_msg=key)
        for key in ("scores", "cls_probs", "masks", "query_embeds"):
            np.testing.assert_allclose(got[key][s].numpy(), np.asarray(want[key]),
                                       rtol=0, atol=1e-5, err_msg=key)


def _gated(rng, R, C, keep_frac, zero_rows=0):
    s = rng.random((R, C)).astype(np.float32)
    s[s < 1 - keep_frac] = 0.0
    if zero_rows:
        s[rng.choice(R, zero_rows, replace=False)] = 0.0
    return s


@pytest.mark.parametrize("R,C,keep,zero_rows,use_mask", [
    (1, 1, 1.0, 0, False), (3, 5, 1.0, 0, False), (7, 30, 1.0, 0, False),
    (30, 40, 0.2, 0, False), (60, 80, 0.4, 40, True), (121, 150, 0.05, 60, True),
])
def test_lsa_gives_jax_columns(R, C, keep, zero_rows, use_mask):
    """Tracker-style gated matrices are full of exact zeros: ties must break
    as in the JAX assignment, column for column."""
    rng = np.random.default_rng(R * 1000 + C)
    for _ in range(3):
        s = _gated(rng, R, C, keep, zero_rows)
        mask = s.any(axis=1) if use_mask else None
        got = lsa_maximize(s, mask)
        want = np.asarray(jax_lsa_maximize(jnp.asarray(s),
                                           None if mask is None else jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)


M, K, T, WIN, KC, C = 8, 6, 2, 4, 3, 8
HW = 16


def _clip(rng, pool_masks, pool_embeds):
    n = rng.integers(1, K)
    take = rng.choice(len(pool_masks), size=n, replace=False)
    masks = np.full((K, T, HW, HW), -8.0, np.float32)
    embeds = np.zeros((K, C), np.float32)
    for i, p in enumerate(take):
        masks[i] = pool_masks[p] + rng.standard_normal((T, HW, HW)) * 0.2
        embeds[i] = pool_embeds[p] + rng.standard_normal(C) * 0.05
    scores = np.sort(rng.random(K).astype(np.float32))[::-1].copy()
    valid = np.arange(K) < n
    cls_probs = np.abs(rng.standard_normal((K, KC))).astype(np.float32)
    return scores, cls_probs, masks, embeds, valid


def _assert_state_equal(got, want):
    for key, w in want.items():
        g = got[key].numpy()
        w = np.asarray(w)
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_tracker_step_and_window_average_match_jax(seed):
    rng = np.random.default_rng(seed)
    pool_masks, pool_embeds = [], []
    for p in range(5):
        m = np.full((T, HW, HW), -8.0, np.float32)
        y, x = (p % 3) * 5, (p // 3) * 7
        m[:, y:y + 4, x:x + 5] = 8.0
        pool_masks.append(m)
        e = np.zeros(C, np.float32)
        e[p] = 6.0
        pool_embeds.append(e)
    kw = dict(num_max_inst=M, num_frames=T, window_frames=WIN, clip_stride=1,
              num_classes=KC, embed_dim=C, mask_hw=(HW, HW), apply_cls_thres=0.05)
    jcfg, tcfg = jtr.TrackerCfg(**kw), ttr.TrackerCfg(**kw)
    jstate = jtr.tracker_state_init(jcfg)
    tstate = ttr.tracker_state_init(tcfg, "cpu")
    start_frame, saved = 0, set()
    for ci in range(9):
        frame_idx = [ci, ci + 1]
        f0 = max(frame_idx[0] - start_frame, 0)
        overlap = np.array([f in saved and f >= start_frame for f in frame_idx])
        scores, cls_probs, masks, embeds, valid = _clip(rng, pool_masks, pool_embeds)
        jstate = jtr.tracker_step(jstate, jcfg, *(jnp.asarray(a) for a in
                                                  (scores, cls_probs, masks, embeds,
                                                   valid)), jnp.int32(f0),
                                  jnp.asarray(overlap))
        tstate = ttr.tracker_step(tstate, tcfg, *(torch.from_numpy(a) for a in
                                                  (scores, cls_probs, masks, embeds,
                                                   valid)), f0, torch.from_numpy(overlap))
        _assert_state_equal(tstate, jstate)
        saved.update(frame_idx)
        last = ci == 8
        if ci + 1 >= WIN * (1 + start_frame // WIN) or last:
            jo = jtr.tracker_window_average(jstate, jcfg, last)
            to = ttr.tracker_window_average(tstate, tcfg, last)
            np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=1e-5,
                                       atol=1e-6)
            assert int(to[1]) == int(jo[1])
            np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), rtol=1e-5,
                                       atol=1e-5)
            jstate, tstate = jo[3], to[3]
            _assert_state_equal(tstate, jstate)
            if not last:
                start_frame += WIN
                saved = {f for f in saved if f >= start_frame}


def test_window_output_masks_match_jax():
    """Finalize (aligned-bilinear x4, crop, threshold, nearest resize to an
    odd original size, bit-pack) of every row: bit-exact."""
    rng = np.random.default_rng(3)
    kw = dict(num_max_inst=5, num_frames=2, window_frames=4, clip_stride=1,
              num_classes=3, embed_dim=4, mask_hw=(6, 7), apply_cls_thres=0.05)
    jcfg, tcfg = jtr.TrackerCfg(**kw), ttr.TrackerCfg(**kw)
    jstate = jtr.tracker_state_init(jcfg)
    tstate = ttr.tracker_state_init(tcfg, "cpu")
    ls = rng.standard_normal((6, 6, 6, 7)).astype(np.float32) * 3
    vc = rng.integers(0, 3, (6, 6)).astype(np.float32)
    jstate = dict(jstate, logit_sum=jnp.asarray(ls), valid_count=jnp.asarray(vc))
    tstate = dict(tstate, logit_sum=torch.from_numpy(ls.copy()),
                  valid_count=torch.from_numpy(vc.copy()))
    jo = jtr.tracker_window_output(jstate, jcfg, 4, (22, 27), (37, 41), True)
    to = ttr.tracker_window_output(tstate, tcfg, 4, (22, 27), (37, 41), True)
    assert to[2].dtype == torch.uint8
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))


def test_inference_video_matches_jax():
    rng = np.random.default_rng(4)
    clips = [rng.random((n, 5)).astype(np.float32) * 0.3 for n in (3, 7, 7)]
    inf = jmeta.InferenceCfg(num_classes=5)
    ws, wl, wi, wt = jmeta.inference_video(inf, clips)
    gs, gl, gi, gt = tmeta.inference_video(clips)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    assert gl == wl and gt == wt
    np.testing.assert_array_equal(gi, wi)
