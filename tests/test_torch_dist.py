"""The port's data parallelism on the CPU: two real ranks (gloo on 127.0.0.1)
against one process and against the JAX package's global-batch step, and the
frame-sharded window encode of ``inference_vis(devices=...)``.

The ranks run ``python -m torch.distributed.run --nproc_per_node 2 -m
mdqe_cvpr2023_tpu_torch.tools.ddp_step`` at the tiny configuration of
``tests/tiny_train.py`` (hidden 64, 1+1 layers, 16 queries, 2-frame clips)
with its weights (JAX's ``detr_init``, carried by
``engine/weights.py::load_jax_params``), dropout 0, on a global batch of 2
clips at 128x128 (no 1x1 pyramid level: GroupNorm over two values makes that
level's gradient ill-conditioned in both frameworks) with two moving
ellipses a clip (``parallel.train.synthetic_batch``, seed 4: each clip's two
instances lie under queries, so both count in the reid loss; tiny_batch's
16-pixel squares lie under none, and its reid loss is 0),
the reid priorities JAX draws from the step's key, and ``eos_coef`` 0.1 (the
no-object weight; at 1 the focal weight sum would not depend on the
matching). Each rank takes one clip.
Cases: fp32, AMP, a batch whose second clip has no valid instance, and one
whose second clip has one valid instance of the first's two, so that every
denominator of the loss (matched pairs, the focal weight sum, the reid
count) differs between the two ranks' halves and the global batch: a
criterion that keeps any of them local fails these tests, whether it
averages the ranks' locally normalized losses or scales them by the world
size.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from mdqe_cvpr2023_tpu.engine.checkpoint import convert_torch_state_dict
from mdqe_cvpr2023_tpu.models import MDQEModelCfg as JaxModelCfg
from mdqe_cvpr2023_tpu.models import detr_init
from mdqe_cvpr2023_tpu.models import meta as jmeta
from mdqe_cvpr2023_tpu.parallel import train as jtrain
from mdqe_cvpr2023_tpu_torch.engine.weights import load_jax_params
from mdqe_cvpr2023_tpu_torch.models import meta as tmeta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.ops import _build
from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc
from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
from mdqe_cvpr2023_tpu_torch.tools import ddp_step
from mdqe_cvpr2023_tpu_torch.utils import dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tiny_train import tiny_batch, tiny_cfgs  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
                enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
                query_embed_dim=8, dec_temporal=True)
CRIT_KW = dict(num_classes=5, n_frames=2, n_query=16, num_points=64, eos_coef=0.1)
HP = WP = 128
LR = ptrain.TrainCfg().base_lr
CASES = {"fp32": dict(amp=False), "amp": dict(amp=True), "empty": dict(amp=False),
         "uneven": dict(amp=False)}
RANK_TIMEOUT_S = 300


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_reid_priorities(key, B, N, T, Q):
    """The uniform draws JAX's ``criterion_apply`` makes from ``key`` (per
    video, per instance, then (positive, negative)), as (B, N, 2, T*Q)."""
    out = np.zeros((B, N, 2, T * Q), np.float32)
    for b, kb in enumerate(jax.random.split(key, B)):
        for n, kn in enumerate(jax.random.split(kb, N)):
            k1, k2 = jax.random.split(kn)
            out[b, n, 0] = np.asarray(jax.random.uniform(k1, (T * Q,)))
            out[b, n, 1] = np.asarray(jax.random.uniform(k2, (T * Q,)))
    return out


def drop_instances(batch, clip, slots):
    """The batch with the instances ``slots`` of clip ``clip`` made invalid."""
    b = {k: v.copy() for k, v in batch.items()}
    b["valid"][clip, slots] = False
    b["ids"][clip, slots] = -1
    b["masks"][clip, slots] = 0.0
    return b


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The ranks' reports, rank 0's state after the first step, the one-process
    steps of the same cases, and the JAX global-batch steps (fp32 cases).
    The ranks run while the test process computes the references."""
    tmp = tmp_path_factory.mktemp("ddp")
    jcfg, jcrit = tiny_cfgs()
    jcrit = dataclasses.replace(jcrit, eos_coef=CRIT_KW["eos_coef"])
    params = jax.tree.map(np.asarray, jax.jit(detr_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu", seed=0)
    load_jax_params(model, params)
    torch.save(model.state_dict(), tmp / "state.pt")
    key = jax.random.PRNGKey(1)
    batches = {"full": ptrain.synthetic_batch(seed=4, clips=2, frames=2, hp=HP, wp=WP,
                                              slots=3, n_inst=2, num_classes=5)}
    batches["empty"] = drop_instances(batches["full"], 1, slice(None))
    batches["uneven"] = drop_instances(batches["full"], 1, 1)
    B, N = batches["full"]["valid"].shape
    np.save(tmp / "pri.npy", jax_reid_priorities(key, B, N, 2, 16))
    for name, b in batches.items():
        np.savez(tmp / f"{name}.npz", **b)
    spec = {"model": MODEL_KW, "crit": CRIT_KW, "train": {}, "state": str(tmp / "state.pt"),
            "cases": [{"name": name, "batch": str(tmp / f"{_batch_of(name)}.npz"),
                       "priorities": str(tmp / "pri.npy"), "steps": 2,
                       **kw} for name, kw in CASES.items()]}
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(free_port()), "-m",
         "mdqe_cvpr2023_tpu_torch.tools.ddp_step", "--spec", str(tmp / "spec.json"),
         "--out", str(tmp / "out"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        one = {c["name"]: ddp_step.run_case(spec, c, "cpu") for c in spec["cases"]}
        # JAX's global-batch step (its own optimizer, dropout 0), fp32
        tx = jtrain.make_optimizer(jtrain.TrainCfg())
        step = jax.jit(jtrain.make_train_step(jcfg, jcrit, tx, dropout_rate=0.0))
        jx = {}
        for name in ("fp32", "empty", "uneven"):
            jb = {k: jnp.asarray(v) for k, v in batches[_batch_of(name)].items()}
            p1, _, total, ldict = step(jax.tree.map(jnp.asarray, params), tx.init(params),
                                       jb, key)
            jx[name] = (jax.tree.map(np.asarray, p1), float(total),
                        {k: float(v) for k, v in ldict.items()})
        out = proc.communicate(timeout=RANK_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"ranks timed out:\n{proc.communicate()[0][-4000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"ranks failed ({proc.returncode}):\n{out[-6000:]}"
    reports = {name: [json.load(open(tmp / "out" / f"{name}_rank{r}.json")) for r in (0, 1)]
               for name in CASES}
    step1 = {name: torch.load(tmp / "out" / f"{name}_step1.pt", weights_only=True)
             for name in CASES}
    return {"reports": reports, "step1": step1, "one": one, "jax": jx,
            "frozen": jtrain.frozen_leaf_mask(params, 2), "batches": batches}


def _batch_of(case):
    return case if case in ("empty", "uneven") else "full"


def _update_diffs(a, b, trainable):
    """|a - b| / lr over the trainable entries of two state dicts."""
    return np.concatenate([(a[k].double() - b[k].double()).abs().flatten().numpy()
                           for k in trainable]) / LR


def _trainable():
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu")
    model.set_trainable(ptrain.TrainCfg().freeze_at)
    return [n for n, p in model.named_parameters() if p.requires_grad]


# --------------------------------------------------------------------------
# collectives and the backend rule
# --------------------------------------------------------------------------

def test_all_gather_objects_is_the_identity_at_world_size_1():
    obj = {"video_id": 3, "segs": [np.arange(5)], "s": "x"}
    out = dist.all_gather_objects(obj)
    assert len(out) == 1 and out[0] is obj
    assert dist.rank() == 0 and dist.world_size() == 1 and dist.is_main_process()
    dist.barrier()  # no group: returns


def test_all_gather_objects_over_two_ranks_with_unequal_payloads(ddp):
    for r in ddp["reports"]["fp32"]:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["gathered"] == [[0, 10], [1, 1010]]


def test_backend_is_chosen_not_fallen_back_to():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert dist.choose_backend(cpu) == "gloo" and dist.choose_backend(card) == "nccl"
    assert dist.choose_backend(card, "gloo") == "gloo"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dist.choose_backend(cpu, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        dist.choose_backend(cpu, "mpi")


def test_nccl_with_two_ranks_on_one_card_raises_the_ports_error():
    store = tdist.HashStore()
    store.set("mdqe_card_1", "host/GPU-0")  # rank 1 already named its card
    with pytest.raises(RuntimeError, match="one rank per card"):
        dist.check_one_rank_per_card(store, 0, 2, "host/GPU-0")
    store = tdist.HashStore()
    store.set("mdqe_card_1", "host/GPU-1")
    dist.check_one_rank_per_card(store, 0, 2, "host/GPU-0")


def test_shard_rows_cuts_clip_and_frame_rows_alike():
    b = tiny_batch(B=4, Hp=64, Wp=64)
    b["reid_priorities"] = np.arange(4 * 3 * 2 * 32).reshape(4, 3, 2, 32)
    parts = [ptrain.shard_rows(b, r, 2) for r in range(2)]
    for k, v in b.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v, err_msg=k)
    assert parts[1]["images"].shape[0] == 4 and parts[1]["valid"].shape[0] == 2
    np.testing.assert_array_equal(parts[1]["images"], b["images"][4:])
    with pytest.raises(ValueError, match="cannot split"):
        ptrain.shard_rows(b, 0, 3)


# --------------------------------------------------------------------------
# the two-rank step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_equals_the_one_process_step(ddp, case):
    """Against the port's one-process step on the global batch, from the
    same weights: the first step's all-reduced total and every loss rtol
    1e-5; after it the updated trainable entries 99% within 0.01 lr, 99.9%
    within 0.05 lr and all within lr, frozen leaves equal (the ranks sum
    another batch split, and Adam's first step is about lr * sign(g), so an
    entry whose gradient is rounding noise can move by up to lr; the second
    step starts from those weights, and its losses are not held); the two
    ranks bit-equal after each of the two steps; each rank held one clip,
    reduced its gradients, and launched no kernel on the CPU."""
    reports = ddp["reports"][case]
    want, want_state = ddp["one"][case]
    want_s = want["steps"][0]
    for r in reports:
        assert r["clips"] == 1 and want["clips"] == 2 and len(r["steps"]) == 2
        got_s = r["steps"][0]
        np.testing.assert_allclose(got_s["total"], want_s["total"], rtol=1e-5)
        assert sorted(got_s["losses"]) == sorted(want_s["losses"])
        for k, v in want_s["losses"].items():
            np.testing.assert_allclose(got_s["losses"][k], v, rtol=1e-5, err_msg=k)
        for s in r["steps"]:
            assert s["allreduce_bytes"] > 0 and s["allreduce_s"] >= 0
            assert all(n == 0 for d in s["launches"].values() for n in d.values())
    assert reports[0]["sha256_step1"] == reports[1]["sha256_step1"]
    assert reports[0]["sha256_final"] == reports[1]["sha256_final"]
    got_state = ddp["step1"][case]
    trainable = set(_trainable())
    d = _update_diffs(got_state, want_state, trainable)
    q99, q999 = np.quantile(d, [0.99, 0.999])
    assert q99 <= 0.01 and q999 <= 0.05 and d.max() <= 1.0, (q99, q999, d.max())
    for k in got_state:
        if k not in trainable:
            assert torch.equal(got_state[k], want_state[k]), k


@pytest.mark.parametrize("case", ["fp32", "empty", "uneven"])
def test_two_rank_step_equals_the_jax_global_batch_step(ddp, case):
    """Against JAX's ``make_train_step`` on the global batch (one process,
    the same weights and priorities, dropout 0): the losses rtol 1e-4; after
    one step the trainable entries 99% within 0.01 lr, 99.9% within 0.05 lr,
    all within lr, and the frozen leaves equal (the bounds of
    tests/test_torch_train_step.py)."""
    p1, total, ldict = ddp["jax"][case]
    step = ddp["reports"][case][0]["steps"][0]
    np.testing.assert_allclose(step["total"], total, rtol=1e-4)
    assert sorted(step["losses"]) == sorted(ldict)
    for k, v in ldict.items():
        np.testing.assert_allclose(step["losses"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    got = convert_torch_state_dict({k: v.numpy() for k, v in ddp["step1"][case].items()})
    diffs = []
    for (kp, a), j, f in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                             jax.tree_util.tree_leaves(p1),
                             jax.tree_util.tree_leaves(ddp["frozen"])):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(j, np.float64)).ravel() / LR
        if f:
            assert d.max() == 0, jax.tree_util.keystr(kp)
        else:
            diffs.append(d)
    d = np.concatenate(diffs)
    q99, q999 = np.quantile(d, [0.99, 0.999])
    assert q99 <= 0.01 and q999 <= 0.05 and d.max() <= 1.0, (q99, q999, d.max())


def test_unequal_cases_give_the_ranks_unequal_instances(ddp):
    """The 'empty' and 'uneven' cases hold the criterion to global counts
    only because their ranks' local counts differ from the global ones: rank
    1's clip has no valid instance, or one of rank 0's two; and the reid loss
    has instances to count."""
    for case, want in (("empty", [2, 0]), ("uneven", [2, 1])):
        assert ddp["batches"][case]["valid"].sum(1).tolist() == want
        assert [r["clips"] for r in ddp["reports"][case]] == [1, 1]
        # the reid loss has instances to count
        assert ddp["reports"][case][0]["steps"][0]["losses"]["loss_reid_query_init"] > 0


# --------------------------------------------------------------------------
# the kernels run with their tensors' device current
# --------------------------------------------------------------------------

class _Current:
    """Stands in for ``torch.cuda.device``: records the device made current
    around each launch."""
    stack = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Current.stack.append(self.device)

    def __exit__(self, *exc):
        _Current.stack.pop()


class _Lib:
    """A kernel library whose launchers record the current device."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, _Current.stack[-1] if _Current.stack else None,
                               args[-1]))
            return 0
        return launcher


def test_kernel_launches_run_with_their_device_current(monkeypatch):
    """Every wrapper launches through ``_build.launch``, which makes the
    tensors' device current on the thread (a launch for cuda:1 from a thread
    where cuda:0 is current would fail; ``inference_vis(devices=)`` drives
    several cards from one thread) and passes that device's stream. The
    launches here run on CPU tensors past the wrappers' device checks, with
    the device guard, the stream and the library stood in for."""
    lib = _Lib()
    streams = []

    class _Stream:
        def __init__(self, device):
            streams.append(device)
            self.cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "device", _Current)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(da, "_check_kernel_inputs", lambda value, shapes, loc, attw, *g: (
        value.shape[0], value.shape[1], loc.shape[1], value.shape[2], value.shape[3],
        loc.shape[3], loc.shape[4]))
    monkeypatch.setattr(tc, "_check_inputs", lambda a, b, reps: (a.shape[0], a.shape[1],
                                                                 b.shape[1]))
    shapes = ((6, 8), (3, 4))
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.standard_normal((1, 60, 2, 32)).astype(np.float32))
    loc = torch.rand(1, 5, 2, 2, 4, 2)
    attw = torch.full((1, 5, 2, 2, 4), 0.125)
    gout = torch.zeros(1, 5, 64)
    da.ms_deform_attn_cuda(value, shapes, loc, attw)
    da.ms_deform_attn_cuda_block(value.bfloat16(), shapes, loc, attw, 256, count=False)
    da.ms_deform_attn_bwd_cuda(value, shapes, loc, attw, gout)
    da.ms_deform_attn_bwd_cuda(value.bfloat16(), shapes, loc, attw, gout)
    tc.tc_kdepth_cuda(torch.zeros(16, 32), torch.zeros(32, 8, dtype=torch.bfloat16), 2,
                      count=False)
    names = [c[0] for c in lib.calls]
    assert names == ["msda_fwd_f32", "msda_fwd_bf16_block", "msda_bwd_f32", "msda_bwd_bf16",
                     "tc_kdepth_bf16"]
    assert all(dev == value.device for _, dev, _ in lib.calls)
    assert all(stream == 1234 for _, _, stream in lib.calls)
    assert streams == [value.device] * 5 and not _Current.stack


# --------------------------------------------------------------------------
# frame-sharded inference_vis
# --------------------------------------------------------------------------

INF_KW = dict(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
              max_num_instances=20, apply_cls_thres=0.05, clip_topk=8,
              encode_chunk=2, num_classes=5, bf16_encode=False)


@pytest.fixture(scope="module")
def vis_inputs():
    params = jax.tree.map(np.asarray, jax.jit(detr_init, static_argnums=1)(
        jax.random.PRNGKey(0), JaxModelCfg(**MODEL_KW)))
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu", seed=1)
    load_jax_params(model, params)
    video = np.random.default_rng(0).integers(0, 255, (9, 60, 62, 3)).astype(np.uint8)
    frames, _ = tmeta.preprocess_frames(video)
    return params, model, frames


def _assert_tracks_close(got, want, score_atol):
    assert got["num_tracks"] == want["num_tracks"]
    assert len(got["pred_scores"]) == len(want["pred_scores"]) >= 1
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], atol=score_atol)
    for mg, mw in zip(got["pred_masks"], want["pred_masks"]):
        assert mg.shape == mw.shape and mg.dtype == bool
        union = np.logical_or(mg, mw).sum()
        assert union == 0 or np.logical_and(mg, mw).sum() / union >= 0.99


@pytest.mark.parametrize("bf16", [False, True])
def test_sharded_inference_vis_equals_unsharded(vis_inputs, bf16):
    """``devices=["cpu"] * 2`` at ``encode_chunk`` 4 (two frames a device)
    against ``devices=None`` at ``encode_chunk`` 2 (two frames an encode
    call, as each device's share): equal. ``devices=["cpu"] * 3`` at
    ``encode_chunk`` 2 (rounded up to 3: one frame a device) against
    ``devices=None`` at 2: the CPU's convolutions round a batch of one frame
    otherwise than one of two, so scores within 1e-6, the same tracks and
    labels, mask IoU >= 0.99."""
    _, model, frames = vis_inputs
    inf = tmeta.InferenceCfg(**dict(INF_KW, bf16_encode=bf16))
    base = tmeta.inference_vis(model, inf, frames, (60, 62), (120, 124), device="cpu")
    two = tmeta.inference_vis(model, dataclasses.replace(inf, encode_chunk=4), frames,
                              (60, 62), (120, 124), device="cpu", devices=["cpu"] * 2)
    assert two["pred_scores"] == base["pred_scores"]
    assert two["pred_labels"] == base["pred_labels"]
    assert two["num_tracks"] == base["num_tracks"]
    for a, b in zip(two["pred_masks"], base["pred_masks"]):
        np.testing.assert_array_equal(a, b)
    three = tmeta.inference_vis(model, inf, frames, (60, 62), (120, 124), device="cpu",
                                devices=["cpu"] * 3)
    _assert_tracks_close(three, base, 1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_sharded_inference_vis_keeps_its_encode_copies(vis_inputs, bf16):
    """A device other than the model's encodes with an ``_EncodeCopy``
    ("cpu:0" is another device than "cpu" to torch, so the CPU runs this
    path): it holds the encode modules only (backbone, input projections,
    encoder, mask head), is built at the first call, kept by the next, and
    built again once the model's encode weights change; the sharded results
    equal the unsharded run's each time."""
    _, _, frames = vis_inputs
    model = MDQEModel(MDQEModelCfg(**MODEL_KW), device="cpu", seed=2)
    inf = tmeta.InferenceCfg(**dict(INF_KW, bf16_encode=bf16))

    def sharded_equals_unsharded():
        base = tmeta.inference_vis(model, inf, frames, (60, 62), (120, 124), device="cpu")
        two = tmeta.inference_vis(model, dataclasses.replace(inf, encode_chunk=4), frames,
                                  (60, 62), (120, 124), device="cpu", devices=["cpu", "cpu:0"])
        assert two["pred_scores"] == base["pred_scores"] and len(base["pred_scores"]) >= 1
        assert two["pred_labels"] == base["pred_labels"]
        for a, b in zip(two["pred_masks"], base["pred_masks"]):
            np.testing.assert_array_equal(a, b)
        return tmeta._ENCODE_COPIES[model][torch.device("cpu", 0)]

    kept = sharded_equals_unsharded()
    prefixes = tmeta.ENCODE_PREFIXES + ("transformer_dec.mask_head.",)
    assert ({n for n, _ in kept[1].named_parameters()}
            == {n for n, _ in model.detr.named_parameters() if n.startswith(prefixes)})
    assert (kept[2] is not None) == bf16
    assert sharded_equals_unsharded() is kept
    with torch.no_grad():
        next(model.detr.transformer_enc.parameters()).mul_(1.01)
    assert sharded_equals_unsharded() is not kept


def test_sharded_inference_vis_matches_jax_mesh(vis_inputs):
    """``devices=["cpu"] * 3`` against JAX's ``inference_vis(mesh=)`` on a
    3-device mesh, the same weights and video: the bounds of
    tests/test_torch_inference_vis.py (tracks and labels equal, scores within
    5e-3, mask IoU >= 0.99)."""
    from jax.sharding import Mesh
    params, model, frames = vis_inputs
    mesh = Mesh(np.asarray(jax.devices()[:3]), ("data",))
    want = jmeta.inference_vis(params, JaxModelCfg(**MODEL_KW), jmeta.InferenceCfg(**INF_KW),
                               frames, image_size=(60, 62), ori_size=(120, 124), mesh=mesh)
    got = tmeta.inference_vis(model, tmeta.InferenceCfg(**INF_KW), frames, (60, 62),
                              (120, 124), device="cpu", devices=["cpu"] * 3)
    _assert_tracks_close(got, want, 5e-3)


def test_sharded_inference_vis_rejects_a_first_device_other_than_the_models(vis_inputs):
    _, model, frames = vis_inputs
    with pytest.raises(ValueError, match="start with"):
        tmeta.inference_vis(model, tmeta.InferenceCfg(**INF_KW), frames, (60, 62), (60, 62),
                            device="cpu", devices=[])
