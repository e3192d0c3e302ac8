"""The port's Trainer and ``train_net`` over two real ranks on the CPU (gloo on
127.0.0.1), started by ``python -m torch.distributed.run``, at the tiny
configuration of tests/synth_dataset.py's TINY_OVERRIDES:

  - ``Trainer.test`` on 5 videos, as tests/test_dist_multiprocess.py holds
    the JAX package's: rank 0 predicts videos [1, 3, 5] and rank 1 [2, 4],
    both end with the predictions of [1..5] in the records' order, only rank
    0 writes the results file, and the predictions and AP equal one
    process's test of the same weights;
  - ``train_net`` for 2 iterations on build_mini_dataset's 2 videos, global
    batch 2, dropout 0: one checkpoint, the ranks' replicas equal (the
    Trainer compares their checksums at each checkpoint), the first
    iteration's losses and the parameters after 2 steps against a one-rank
    run of the same global batch, and a resumed third iteration.

Run as a script (``--worker test OUT DS``) this file is one rank of the
``Trainer.test`` check.
"""
import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from synth_dataset import TINY_OVERRIDES, build_mini_dataset  # noqa: E402

CONFIG = os.path.join(REPO, "configs", "R50_ovis_360.yaml")
TIMEOUT_S = 300
LR = 1e-4  # SOLVER.BASE_LR of the config


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, ranks=2):
    """``args`` under torch.distributed.run with ``ranks`` processes (or as
    one plain process with ``ranks=0``) on 127.0.0.1, from the repository."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    pre = [sys.executable]
    if ranks:
        pre += ["-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
                "--master_addr", "127.0.0.1", "--master_port", str(_free_port())]
    return subprocess.Popen(pre + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc, timeout=TIMEOUT_S):
    """The process's output; it fails the test on a non-zero exit, and is
    killed past ``timeout``."""
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"timed out after {timeout} s:\n{proc.communicate()[0][-4000:]}")
    assert proc.returncode == 0, f"exit {proc.returncode}:\n{out[-6000:]}"
    return out


def write_five_videos(root):
    """5 one-object videos of 2 frames of 64x64 (ids 1..5) in the OVIS layout,
    the same split for train and dev."""
    from PIL import Image
    from mdqe_cvpr2023_tpu_torch.data import rle
    videos, anns = [], []
    for vid in range(1, 6):
        os.makedirs(os.path.join(root, "ovis", "train", f"v{vid}"), exist_ok=True)
        names, segs = [], []
        for t in range(2):
            img = np.full((64, 64, 3), 30, np.uint8)
            m = np.zeros((64, 64), bool)
            m[8 + 4 * t + vid:26 + 4 * t + vid, 6 * vid:6 * vid + 20] = True
            img[m] = [200, 60, 60]
            name = f"v{vid}/f{t}.png"
            Image.fromarray(img).save(os.path.join(root, "ovis", "train", name))
            names.append(name)
            segs.append(rle.encode(m))
        videos.append({"id": vid, "file_names": names, "height": 64, "width": 64,
                       "length": 2})
        anns.append({"id": vid, "video_id": vid, "category_id": 1, "segmentations": segs,
                     "bboxes": [[6.0 * vid, 8.0 + 4 * t + vid, 20.0, 18.0] for t in range(2)],
                     "areas": [360, 360], "iscrowd": 0})
    gt = {"videos": videos, "annotations": anns, "categories": [{"id": 1, "name": "thing"}]}
    for split in ("annotations_train.json", "valid_sub.json"):
        with open(os.path.join(root, "ovis", split), "w") as f:
            json.dump(gt, f)
    return root


def _test_cfg(out_dir):
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    return load_config(CONFIG, TINY_OVERRIDES + ["OUTPUT_DIR", str(out_dir)])


def worker(out, ds):
    """One rank of the Trainer.test check: joins the group, tests the tiny
    model (seed 0) on the 5 videos into ``<out>/rank<r>`` and writes what it
    saw to ``<out>/report_<r>.json``."""
    from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
    from mdqe_cvpr2023_tpu_torch.utils import dist
    torch.set_num_threads(2)
    dist.init_from_env("cpu")
    r = dist.rank()
    trainer = Trainer(_test_cfg(os.path.join(out, f"rank{r}")), datasets_root=ds,
                      device="cpu")
    seen = []
    predict = trainer.predict_videos

    def spy(records, *args, **kw):
        seen.extend(rec["video_id"] for rec in records)
        return predict(records, *args, **kw)

    trainer.predict_videos = spy
    metrics, predictions = trainer.test()
    report = {"rank": r, "world": dist.world_size(), "seen": seen,
              "gathered": [p["video_id"] for p in predictions],
              "predictions": predictions, "metrics": metrics,
              "wrote": os.path.exists(os.path.join(out, f"rank{r}",
                                                   "results_ytvis_ovis_dev.json"))}
    with open(os.path.join(out, f"report_{r}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy()


def _cli(ds, out, extra=()):
    return ["-m", "mdqe_cvpr2023_tpu_torch.train_net", "--config-file", CONFIG,
            "--datasets-root", str(ds), "--log-every", "1", "--device", "cpu", *extra,
            *TINY_OVERRIDES, "SOLVER.IMS_PER_BATCH", "2", "MODEL.MDQE.DROPOUT", "0.0",
            "TEST.EVAL_PERIOD", "0", "DATALOADER.NUM_WORKERS", "0",
            "SOLVER.CHECKPOINT_PERIOD", "100", "OUTPUT_DIR", str(out)]


def _rows(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs, started together: Trainer.test over 2 ranks (5 videos);
    train_net over 2 ranks and in one process (2 iterations each, then test);
    then train_net over 2 ranks resumed for a third iteration."""
    tmp = tmp_path_factory.mktemp("dist_trainer")
    five = write_five_videos(str(tmp / "five"))
    mini = build_mini_dataset(str(tmp / "mini"))
    procs = {"test": _start([os.path.abspath(__file__), "--worker", "test",
                             str(tmp / "test"), five]),
             "two": _start(_cli(mini, tmp / "two", ["--max-iter", "2"])),
             "one": _start(_cli(mini, tmp / "one", ["--max-iter", "2"]), ranks=0)}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = _wait(proc)
        outs["resumed"] = _wait(_start(_cli(
            mini, tmp / "two", ["--max-iter", "3", "--resume",
                                str(tmp / "two" / "ckpt_0000002.pth")])))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"tmp": tmp, "five": five, "outs": outs}


def test_trainer_test_splits_videos_gathers_and_writes_once(runs):
    tmp = runs["tmp"]
    reports = [json.load(open(tmp / "test" / f"report_{r}.json")) for r in (0, 1)]
    assert [r["world"] for r in reports] == [2, 2]
    assert reports[0]["seen"] == [1, 3, 5] and reports[1]["seen"] == [2, 4]
    gathered = [sorted(set(r["gathered"])) for r in reports]
    assert gathered == [[1, 2, 3, 4, 5]] * 2
    assert reports[0]["gathered"] == sorted(reports[0]["gathered"])  # the records' order
    assert reports[0]["predictions"] == reports[1]["predictions"]
    assert reports[0]["wrote"] and not reports[1]["wrote"]
    assert reports[0]["metrics"] is not None and reports[1]["metrics"] is None
    with open(tmp / "test" / "rank0" / "results_ytvis_ovis_dev.json") as f:
        assert json.load(f) == reports[0]["predictions"]
    row = _rows(tmp / "test" / "rank0")[-1]
    assert row["videos_per_rank"] == [[1, 3, 5], [2, 4]] and row["world_size"] == 2
    assert row["clips"] == 5 and row["predictions"] == len(reports[0]["predictions"])
    assert not os.path.exists(tmp / "test" / "rank1" / "metrics.jsonl")

    # one process, the same weights (seed 0): the same predictions and AP
    from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
    torch.set_num_threads(2)
    single = Trainer(_test_cfg(tmp / "test" / "single"), datasets_root=runs["five"],
                     device="cpu")
    metrics, predictions = single.test()
    assert predictions == reports[0]["predictions"]
    assert metrics == reports[0]["metrics"] or all(
        a == b or (np.isnan(a) and np.isnan(b))
        for a, b in ((metrics[k], reports[0]["metrics"][k]) for k in metrics
                     if not isinstance(metrics[k], dict)))


def test_train_net_two_ranks_equal_one_rank_and_resume(runs):
    """Rank 0's rows against the one-process run's: iteration 1's total and
    every loss rtol 1e-5 (the same weights; the ranks' denominators are
    global), world size and backend recorded, gradient all-reduce seconds on
    each logged row. One checkpoint, whose row carries the replicas' common
    checksum; its trainable entries within 2 lr of the one-process run's
    after 2 steps and 99% within 0.01 lr (each Adam step moves an entry by
    about lr * sign(g); an entry whose gradient is rounding noise can move
    either way), frozen ones equal. The resumed run takes iteration 3 from
    the checkpoint's step count and writes its own checkpoint."""
    tmp = runs["tmp"]
    two, one = _rows(tmp / "two"), _rows(tmp / "one")
    steps2 = [r for r in two if "total_loss" in r]
    steps1 = [r for r in one if "total_loss" in r]
    assert [r["iteration"] for r in steps2] == [1, 2, 3] and [r["iteration"] for r in steps1] \
        == [1, 2]
    losses = [k for k in steps1[0] if k.startswith("loss_")]
    assert len(losses) >= 8
    for k in ["total_loss"] + losses:
        np.testing.assert_allclose(steps2[0][k], steps1[0][k], rtol=1e-5, err_msg=k)
    for r in steps2:
        assert r["world_size"] == 2 and r["dist_backend"] == "gloo" and r["allreduce_s"] > 0
    assert steps1[0]["world_size"] == 1 and steps1[0]["dist_backend"] is None
    assert steps1[0]["allreduce_s"] == 0.0
    ckpt_rows = [r for r in two if "checkpoint" in r]
    assert [r["iteration"] for r in ckpt_rows] == [2, 3]
    assert all(len(r["state_sha256"]) == 64 for r in ckpt_rows)
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp / "two" / "ckpt_*"))) == \
        ["ckpt_0000002.pth", "ckpt_0000003.pth"]
    assert "saved checkpoint" in runs["outs"]["two"]
    assert runs["outs"]["two"].count("saved checkpoint") == 1  # rank 0 alone

    a = torch.load(tmp / "two" / "ckpt_0000002.pth", weights_only=True)
    b = torch.load(tmp / "one" / "ckpt_0000002.pth", weights_only=True)
    assert a["iteration"] == b["iteration"] == 2 and a["step_count"] == b["step_count"] == 2
    from mdqe_cvpr2023_tpu_torch.engine.build import build_model_cfg
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    model = MDQEModel(build_model_cfg(load_config(CONFIG, TINY_OVERRIDES)), device="cpu")
    model.set_trainable(2)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    d = np.concatenate([(a["model"][k].double() - b["model"][k].double()).abs().flatten()
                        .numpy() for k in trainable]) / LR
    assert d.max() <= 2.0 and np.quantile(d, 0.99) <= 0.01, (d.max(), np.quantile(d, 0.99))
    for k in a["model"]:
        if k not in trainable:
            assert torch.equal(a["model"][k], b["model"][k]), k
    c = torch.load(tmp / "two" / "ckpt_0000003.pth", weights_only=True)
    assert c["iteration"] == 3 and c["step_count"] == 3
    tests = [r for r in two if "test" in r]
    assert [r["iteration"] for r in tests] == [2, 3]
    assert all(r["videos_per_rank"] == [[1], [2]] for r in tests)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    if sys.argv[2] != "test":
        raise SystemExit(f"unknown worker {sys.argv[2]}")
    worker(sys.argv[3], sys.argv[4])
