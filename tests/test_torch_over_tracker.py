"""The port's host OverTracker and mask-memory functions against the JAX
package's, and the port's device tracker against the port's OverTracker, on
the CPU with clip streams made by numpy from a seed (the streams of
tests/test_device_tracker.py, and one that fills the tracker and rolls over
windows). The matched IDs of every clip must be equal (both trackers assign
with scipy on the same float32 scores); class averages agree within 1e-6 and
the bit-packed window masks are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.tracking import ClipResults as JClipResults
from mdqe_cvpr2023_tpu.tracking import OverTracker as JOverTracker
from mdqe_cvpr2023_tpu.tracking import mask_memory as jmm
from mdqe_cvpr2023_tpu.tracking import over_tracker as jot
from mdqe_cvpr2023_tpu_torch.tracking import ClipResults, OverTracker, ctt_similarity
from mdqe_cvpr2023_tpu_torch.tracking import device_tracker as tdt
from mdqe_cvpr2023_tpu_torch.tracking import mask_memory as tmm

torch.set_num_threads(2)

# (M, K, T, WIN, KC, C, H, W, pool, clips): the device-tracker test's stream,
# and a crowded one that fills M and rolls over two windows
SMALL = (8, 6, 2, 4, 3, 8, 16, 16, 5, 9)
CROWDED = (10, 6, 3, 4, 3, 16, 12, 14, 16, 12)
FINALIZE = (4, (45, 53), (37, 41))   # match stride, image size, original size


def _pool(rng, n, T, H, W, C):
    """Separated box masks and distinct embeddings (those of
    tests/test_device_tracker.py when n <= 5)."""
    masks, embeds = [], []
    for p in range(n):
        m = np.full((T, H, W), -8.0, np.float32)
        y, x = (p % 3) * 5, (p // 3) * 7 % max(W - 5, 1)
        m[:, y:y + 4, x:x + 5] = 8.0
        masks.append(m)
        e = np.zeros(C, np.float32)
        e[p % C] = 6.0
        e[(p + 3) % C] += 3.0 * (p >= C)
        embeds.append(e)
    return masks, embeds


def _clip_arrays(rng, pool_masks, pool_embeds, K, T, H, W, KC, C):
    """A random subset of the pool with noise (tests/test_device_tracker.py's
    ``_make_clip``)."""
    n = rng.integers(1, K)
    take = rng.choice(len(pool_masks), size=n, replace=False)
    masks = np.zeros((K, T, H, W), np.float32) - 8.0
    embeds = np.zeros((K, C), np.float32)
    for i, p in enumerate(take):
        masks[i] = pool_masks[p] + rng.standard_normal((T, H, W)) * 0.2
        embeds[i] = pool_embeds[p] + rng.standard_normal(C) * 0.05
    scores = np.sort(rng.random(K).astype(np.float32))[::-1].copy()
    valid = np.arange(K) < n
    cls_probs = np.abs(rng.standard_normal((K, KC))).astype(np.float32)
    return scores, cls_probs, masks, embeds, valid


def _stream(spec, seed):
    """Yields (frame_idx, arrays, is_output, is_last) in inference_vis's
    schedule at clip stride 1."""
    M, K, T, WIN, KC, C, H, W, n_pool, n_clips = spec
    rng = np.random.default_rng(seed)
    pool_masks, pool_embeds = _pool(rng, n_pool, T, H, W, C)
    saved = 0
    for ci in range(n_clips):
        arrays = _clip_arrays(rng, pool_masks, pool_embeds, K, T, H, W, KC, C)
        last = ci == n_clips - 1
        out = ci + 1 >= WIN * (saved + 1)
        if out and not last:
            saved += 1
        yield list(range(ci, ci + T)), arrays, out, last


def _trackers(spec):
    M, K, T, WIN, KC, C, H, W, _, _ = spec
    kw = dict(num_max_inst=M, num_frames=T, window_frames=WIN, clip_stride=1,
              num_classes=KC, embed_dim=C, mask_size=(H, W), apply_cls_thres=0.05)
    return JOverTracker(**kw), OverTracker(**kw, device="cpu")


def _jax_clip(frame_idx, arrays):
    scores, cls_probs, masks, embeds, valid = arrays
    return JClipResults(frame_idx=frame_idx, scores=scores, classes=np.zeros(len(scores)),
                        cls_probs=cls_probs, mask_logits=jnp.asarray(masks),
                        query_embeds=embeds, valid=valid)


def _port_clip(frame_idx, arrays):
    scores, cls_probs, masks, embeds, valid = arrays
    return ClipResults(frame_idx=frame_idx, scores=scores, classes=np.zeros(len(scores)),
                       cls_probs=cls_probs, mask_logits=torch.from_numpy(masks.copy()),
                       query_embeds=embeds, valid=valid)


@pytest.fixture
def jax_slots(monkeypatch):
    """The slots JAX's OverTracker hands to ``mem_update`` each clip: its
    matched IDs (the JAX ``update`` returns nothing)."""
    seen = []

    def recording(logit_sum, valid_count, clip_count, masks, slots, f0):
        seen.append(np.asarray(slots).astype(np.int64))
        return jmm.mem_update(logit_sum, valid_count, clip_count, masks, slots, f0)

    monkeypatch.setattr(jot, "mem_update", recording)
    return seen


STREAMS = [(SMALL, 0), (SMALL, 1), (SMALL, 2), (CROWDED, 3)]


@pytest.mark.parametrize("spec,seed", STREAMS, ids=["seed0", "seed1", "seed2", "crowded"])
def test_over_tracker_matches_jax(spec, seed, jax_slots):
    jtr, ttr = _trackers(spec)
    n_windows = 0
    for frame_idx, arrays, out, last in _stream(spec, seed):
        jtr.update(_jax_clip(frame_idx, arrays))
        slots = ttr.update(_port_clip(frame_idx, arrays))
        np.testing.assert_array_equal(slots, jax_slots[-1])
        assert ttr.num_inst == jtr.num_inst
        np.testing.assert_allclose(ttr.embeds_mem, jtr.embeds_mem, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ttr.untracked_clips, jtr.untracked_clips)
        np.testing.assert_allclose(ttr.logit_sum.numpy(), np.asarray(jtr.logit_sum),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ttr.valid_count.numpy(), np.asarray(jtr.valid_count))
        if out or last:
            jc, jm, jl = jtr.get_result(is_last_clip=last, finalize_args=FINALIZE)
            tc, tm, tl = ttr.get_result(is_last_clip=last, finalize_args=FINALIZE)
            assert tl == jl and tc.shape == jc.shape
            np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
            assert tm.dtype == torch.uint8
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(ttr.clip_count, jtr.clip_count)
            np.testing.assert_allclose(ttr.logit_sum.numpy(), np.asarray(jtr.logit_sum),
                                       rtol=1e-6, atol=1e-6)
            assert ttr.start_frame == jtr.start_frame and ttr.num_clip == jtr.num_clip
            n_windows += 1
        if last:
            break
    assert n_windows >= 2
    if spec is CROWDED:
        assert ttr.num_inst == spec[0]  # the stream fills the tracker


def test_over_tracker_get_result_averages_without_finalize():
    """Without finalize_args the masks are the averaged logits (M+1 rows) and
    the rollover is ``mem_rollover``'s."""
    jtr, ttr = _trackers(SMALL)
    for frame_idx, arrays, out, last in _stream(SMALL, 5):
        jtr.update(_jax_clip(frame_idx, arrays))
        ttr.update(_port_clip(frame_idx, arrays))
        if out or last:
            jc, jm, _ = jtr.get_result(is_last_clip=last)
            tc, tm, _ = ttr.get_result(is_last_clip=last)
            np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
        if last:
            break


@pytest.mark.parametrize("spec,seed", STREAMS, ids=["seed0", "seed1", "seed2", "crowded"])
def test_device_tracker_matches_port_over_tracker(spec, seed):
    M, K, T, WIN, KC, C, H, W, _, _ = spec
    _, host = _trackers(spec)
    cfg = tdt.TrackerCfg(num_max_inst=M, num_frames=T, window_frames=WIN, clip_stride=1,
                         num_classes=KC, embed_dim=C, mask_hw=(H, W), apply_cls_thres=0.05)
    state = tdt.tracker_state_init(cfg, "cpu")
    match_stride, image_size, ori_size = FINALIZE
    for frame_idx, arrays, out, last in _stream(spec, seed):
        f0, overlap = host.clip_offsets(frame_idx)
        scores, cls_probs, masks, embeds, valid = (torch.from_numpy(a.copy()) for a in arrays)
        state = tdt.tracker_step(state, cfg, scores, cls_probs, masks, embeds, valid, f0,
                                 torch.from_numpy(overlap))
        slots = host.update(_port_clip(frame_idx, arrays))
        np.testing.assert_array_equal(state["slots"].numpy(), slots)
        assert int(state["num_inst"]) == host.num_inst
        np.testing.assert_allclose(state["cls_sum"].numpy(), host.cls_sum, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(state["embeds_mem"].numpy(), host.embeds_mem,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(state["logit_sum"].numpy(), host.logit_sum.numpy())
        if out or last:
            hc, hm, _ = host.get_result(is_last_clip=last, finalize_args=FINALIZE)
            dc, n, dm, state = tdt.tracker_window_output(state, cfg, match_stride, image_size,
                                                         ori_size, last)
            assert int(n) == hc.shape[0]
            np.testing.assert_allclose(dc.numpy()[:int(n)], hc, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(dm.numpy(), hm.numpy())
            np.testing.assert_array_equal(state["clip_count"].numpy(), host.clip_count)
        if last:
            break


def _tiny_clip(cls, frame_idx, masks, emb, probs, scores, K=4):
    """A fixed-capacity clip from n valid detections (tests/test_inference_vis.py's
    ``_clip``) for the port's or the JAX package's ClipResults ``cls``."""
    n, T, H, W = masks.shape
    pad = K - n
    m = np.concatenate([masks, np.zeros((pad, T, H, W), np.float32)])
    return cls(frame_idx=frame_idx,
               scores=np.concatenate([scores, np.zeros(pad)]),
               classes=np.concatenate([np.arange(n), np.zeros(pad, np.int64)]),
               cls_probs=np.concatenate([probs, np.zeros((pad, probs.shape[1]), np.float32)]),
               mask_logits=torch.from_numpy(m) if cls is ClipResults else jnp.asarray(m),
               query_embeds=np.concatenate([emb, np.zeros((pad, emb.shape[1]), np.float32)]),
               valid=np.arange(K) < n)


def _tiny_trackers():
    kw = dict(num_max_inst=10, num_frames=2, window_frames=4, clip_stride=1, num_classes=3,
              embed_dim=8, mask_size=(16, 16), apply_cls_thres=0.05)
    return OverTracker(**kw, device="cpu"), JOverTracker(**kw)


def test_tracker_association_identity():
    """tests/test_inference_vis.py's case on the port: two identical clips
    associate to the same instance IDs."""
    rng = np.random.default_rng(1)
    masks = rng.standard_normal((2, 2, 16, 16)).astype(np.float32) * 5
    emb = rng.standard_normal((2, 8)).astype(np.float32)
    probs = np.abs(rng.standard_normal((2, 3))).astype(np.float32)
    tr, jtr = _tiny_trackers()
    for frame_idx in ([0, 1], [1, 2]):
        for t, cls in ((tr, ClipResults), (jtr, JClipResults)):
            t.update(_tiny_clip(cls, frame_idx, masks, emb, probs, np.array([0.9, 0.8])))
        assert tr.num_inst == jtr.num_inst == 2
    out_cls, avg, len_frames = tr.get_result(is_last_clip=True)
    j_cls, j_avg, _ = jtr.get_result(is_last_clip=True)
    assert out_cls.shape == (2, 3) and avg.shape[0] == 11 and len_frames == 3
    np.testing.assert_allclose(out_cls, j_cls, rtol=0, atol=1e-6)
    np.testing.assert_allclose(avg.numpy(), np.asarray(j_avg), rtol=1e-6, atol=1e-6)


def test_tracker_new_instance_registration():
    """tests/test_inference_vis.py's case on the port: a disjoint mask with an
    orthogonal embedding and a high score registers a new ID."""
    tr, jtr = _tiny_trackers()
    m0 = np.full((2, 2, 16, 16), -10.0, np.float32)
    m0[0, :, :4, :4] = 10.0
    m0[1, :, 6:9, 6:9] = 10.0
    e0 = np.zeros((2, 8), np.float32)
    e0[0, 0] = e0[1, 1] = 10.0
    p0 = np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]], np.float32)
    m1 = np.full((1, 2, 16, 16), -10.0, np.float32)
    m1[:, :, 10:, 10:] = 10.0
    e1 = np.zeros((1, 8), np.float32)
    e1[0, 2] = 10.0
    p1 = np.array([[0.1, 0.1, 0.9]], np.float32)
    for t, cls in ((tr, ClipResults), (jtr, JClipResults)):
        t.update(_tiny_clip(cls, [0, 1], m0, e0, p0, np.array([0.9, 0.9])))
        t.update(_tiny_clip(cls, [1, 2], m1, e1, p1, np.array([0.9])))
    assert tr.num_inst == jtr.num_inst == 3


def test_over_tracker_rejects_masks_on_another_device():
    tr, _ = _tiny_trackers()
    clip = _tiny_clip(ClipResults, [0, 1], np.zeros((1, 2, 16, 16), np.float32),
                      np.ones((1, 8), np.float32), np.ones((1, 3), np.float32),
                      np.array([0.9]))
    clip.mask_logits = clip.mask_logits.to("meta")
    with pytest.raises(ValueError, match="mask logits on meta"):
        tr.update(clip)


def test_ctt_similarity_matches_jax():
    rng = np.random.default_rng(7)
    for ns, ni in ((1, 1), (1, 5), (4, 1), (6, 9)):
        a = rng.standard_normal((ns, 8)).astype(np.float32)
        b = rng.standard_normal((ni, 8)).astype(np.float32)
        np.testing.assert_array_equal(ctt_similarity(a, b), jot.ctt_similarity(a, b))


def _memory(rng, m1=7, L=6, h=6, w=7):
    ls = rng.standard_normal((m1, L, h, w)).astype(np.float32) * 3
    vc = rng.integers(0, 3, (m1, L)).astype(np.float32)
    cc = rng.integers(0, 3, (m1,)).astype(np.float32)
    return ls, vc, cc


def test_mem_init_matches_jax():
    got = tmm.mem_init(5, 6, 7, 8, "cpu")
    want = jmm.mem_init(5, 6, 7, 8)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mem_rollover_matches_jax():
    ls, vc, cc = _memory(np.random.default_rng(0))
    got = tmm.mem_rollover(*(torch.from_numpy(a) for a in (ls, vc, cc)), 4)
    want = jmm.mem_rollover(*(jnp.asarray(a) for a in (ls, vc, cc)), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inst_chunk", [3, 8])
def test_mem_finalize_masks_matches_jax(inst_chunk):
    ls, vc, _ = _memory(np.random.default_rng(1))
    avg = ls / np.clip(vc, 1, None)[:, :, None, None]
    got = tmm.mem_finalize_masks(torch.from_numpy(avg), 4, (22, 27), (37, 41), inst_chunk)
    want = jmm.mem_finalize_masks(jnp.asarray(avg), 4, (22, 27), (37, 41),
                                  inst_chunk=inst_chunk)
    assert got.dtype == torch.uint8 and got.shape == (7, 6, 37, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rollover", [True, False])
def test_mem_window_output_matches_jax(rollover):
    ls, vc, cc = _memory(np.random.default_rng(2))
    got = tmm.mem_window_output(*(torch.from_numpy(a.copy()) for a in (ls, vc, cc)), 4, 4,
                                (22, 27), (37, 41), rollover)
    want = jmm.mem_window_output(*(jnp.asarray(a) for a in (ls, vc, cc)), 4, 4, (22, 27),
                                 (37, 41), rollover)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
