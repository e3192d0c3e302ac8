"""The PyTorch port's windowed VIS inference against the JAX package's, on the
CPU, at the tiny configuration of tests/test_inference_vis.py (fp32 encode on
both sides) with the same detr_init weights and the same 9-frame video.

Bounds are those of the full-pipeline oracle: the same tracks and labels,
scores within 5e-3, per-track mask IoU >= 0.99. Masks come from logits
thresholded at 0, so a logit within float noise of 0 may flip a pixel."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import detr_init
from mdqe_cvpr2023_tpu.models import meta as jmeta
from mdqe_cvpr2023_tpu_torch.engine.weights import (jax_tree_to_state_dict,
                                                    load_jax_params)
from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg

torch.set_num_threads(2)

MODEL_KW = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
                enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
                query_embed_dim=8, dec_temporal=True)
INF_KW = dict(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
              max_num_instances=20, apply_cls_thres=0.05, clip_topk=8,
              encode_chunk=2, num_classes=5, bf16_encode=False)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxModelCfg(**MODEL_KW)
    return jax.tree.map(np.asarray, jax.jit(detr_init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu", seed=1)
    load_jax_params(model, jax_params)
    return model


def test_load_jax_params_copies_every_leaf(jax_params, port_model):
    sd = port_model.state_dict()
    flat = jax_tree_to_state_dict(jax_params)
    assert set(flat) == set(sd)
    for name, arr in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_load_jax_params_fails_loudly(jax_params, fault):
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu")
    tree = dict(jax_params, transformer_dec=dict(jax_params["transformer_dec"]))
    dec = tree["transformer_dec"]
    if fault == "missing":
        del dec["point2pos_proj"]
    elif fault == "unexpected":
        dec["extra"] = {"weight": np.zeros(3, np.float32)}
    else:
        dec["point2pos_proj"] = {"weight": np.zeros((3, 2), np.float32),
                                 "bias": dec["point2pos_proj"]["bias"]}
    with pytest.raises((KeyError, ValueError)):
        load_jax_params(model, tree)


def test_inference_vis_matches_jax(jax_params, port_model):
    rng = np.random.default_rng(0)
    video = rng.integers(0, 255, (9, 60, 62, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(video)
    jframes, _ = jmeta.preprocess_frames(video)
    np.testing.assert_array_equal(frames, jframes)

    want = jmeta.inference_vis(jax_params, JaxModelCfg(**MODEL_KW),
                               jmeta.InferenceCfg(**INF_KW), jframes,
                               image_size=(60, 62), ori_size=(120, 124))
    got = tmeta.inference_vis(port_model, tmeta.InferenceCfg(**INF_KW), frames,
                              image_size=(60, 62), ori_size=(120, 124),
                              device="cpu")

    assert got["image_size"] == (120, 124)
    assert got["num_tracks"] == want["num_tracks"]
    assert len(got["pred_scores"]) == len(want["pred_scores"]) >= 1
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], atol=5e-3)
    for mg, mw in zip(got["pred_masks"], want["pred_masks"]):
        assert mg.shape == mw.shape == (9, 120, 124) and mg.dtype == bool
        union = np.logical_or(mg, mw).sum()
        assert union == 0 or np.logical_and(mg, mw).sum() / union >= 0.99


def test_slab_budget_eviction_is_exact(port_model):
    """A 1-byte slab budget finalizes windows early (all live rows); the output
    must equal the deferred path's."""
    rng = np.random.default_rng(7)
    video = rng.integers(0, 255, (11, 60, 62, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(video)
    inf = tmeta.InferenceCfg(**INF_KW)
    ref = tmeta.inference_vis(port_model, inf, frames, (60, 62), (60, 62),
                              device="cpu")
    evict = tmeta.inference_vis(port_model,
                                dataclasses.replace(inf, slab_hbm_budget=1),
                                frames, (60, 62), (60, 62), device="cpu")
    assert ref["pred_scores"] == evict["pred_scores"]
    assert ref["pred_labels"] == evict["pred_labels"]
    for a, b in zip(ref["pred_masks"], evict["pred_masks"]):
        np.testing.assert_array_equal(a, b)


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MDQEModel(MDQEModelCfg(**MODEL_KW))


def test_tail_clip_decodes_the_clamped_frames_as_jax(jax_params, port_model, monkeypatch):
    """Pins the mirrored tail-clip behaviour (ROADMAP, "Faults found"): 9
    frames, clips of 2 at stride 2, windows of 4. The tail clip is shifted
    back to frames 7-8 and is the first clip of its window [8, 9), so its
    offset -1 is clamped to 0 and it decodes frame 8 twice, in the JAX
    package's dynamic_slice and in the port alike."""
    def decoded(offsets, window_len, ws, we):
        offs = [min(max(int(o), 0), window_len - 2) for o in offsets]
        return [[min(ws + o + t, we - 1) for t in range(2)] for o in offs]

    port_calls, jax_calls = [], []
    t_decode, j_decode = tmeta.decode_clips_batched, jmeta._decode_clips_batched

    def t_spy(model, enc, mflat, maskf, offsets, *args, **kw):
        port_calls.append((list(offsets), enc.shape[0]))
        return t_decode(model, enc, mflat, maskf, offsets, *args, **kw)

    def j_spy(params, cfg, enc, mflat, maskf, offsets, *args, **kw):
        jax_calls.append((np.asarray(offsets).tolist(), enc.shape[0]))
        return j_decode(params, cfg, enc, mflat, maskf, offsets, *args, **kw)

    monkeypatch.setattr(tmeta, "decode_clips_batched", t_spy)
    monkeypatch.setattr(jmeta, "_decode_clips_batched", j_spy)
    video = np.random.default_rng(0).integers(0, 255, (9, 60, 62, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(video)
    jmeta.inference_vis(jax_params, JaxModelCfg(**MODEL_KW), jmeta.InferenceCfg(**INF_KW),
                        frames, image_size=(60, 62), ori_size=(60, 62))
    tmeta.inference_vis(port_model, tmeta.InferenceCfg(**INF_KW), frames,
                        image_size=(60, 62), ori_size=(60, 62), device="cpu")
    windows = [(0, 4), (4, 8), (8, 9)]
    assert len(port_calls) == len(jax_calls) == len(windows)
    # the real clips of each group (the rest pad the batch of 8)
    n_real = [2, 2, 1]
    got = [decoded(o[:n], L, *w) for (o, L), n, w in zip(port_calls, n_real, windows)]
    want = [decoded(o[:n], L, *w) for (o, L), n, w in zip(jax_calls, n_real, windows)]
    assert got == want == [[[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 8]]]
    assert jax_calls[-1][0][0] == -1 and port_calls[-1][0][0] == 0
