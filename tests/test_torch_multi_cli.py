"""Port, the scale-out entry points end to end on the CPU (counterpart of
tests/test_multi_cli_e2e.py), on tiny datasets the port's writer made:

  - `python -m gaussianavatar_torch.train_multi` with 4 subjects of unequal
    frame counts (6, 4, 4, 4) and `--dp 2` (two gloo ranks on the CPU):
    per-subject saves, metrics and log PNGs, resume from the saves (the
    iteration and the optimizer counts go on), then the port's eval on a
    4-frame subject;
  - `python -m gaussianavatar_torch.train --dp 2`: its logged losses and
    its save are the `--dp 1` run's, then resume and eval;
  - stage 2 under `train_multi`: every subject boots from the one stage-1
    save, with a warning (ROADMAP F14);
  - the refusals: a batch size that --dp does not divide, subjects that do
    not share a UV atlas or an image size.

Every data-parallel run joins its ranks within JOIN_TIMEOUT_S, so a hung
rendezvous fails the test instead of stalling the suite."""

import json
import os
import shutil
from os.path import join
from unittest import mock

import numpy as np
import pytest
import torch

from gaussianavatar_torch import eval as eval_cli, train, train_multi
from gaussianavatar_torch.engine import checkpoint as ckpt
from gaussianavatar_torch.parallel import mesh
from gaussianavatar_torch.utils import cuda_build

torch.set_num_threads(2)

SMALL_ARGS = ["--dataset_type", "synthetic", "--query_posmap_size", "32",
              "--inp_posmap_size", "16", "--c_geom", "8", "--c_pose", "8", "--nf", "4",
              "--hsize", "16", "--bf16_decoder", "0", "--tile_size", "16", "--device", "cpu"]
FRAMES = {"subjA": 6, "subjB": 4, "subjC": 4, "subjD": 4}
JOIN_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    root = tmp_path_factory.mktemp("multidata")
    for name, n in FRAMES.items():
        write_synthetic_dataset(str(root / name), n_train=n, n_test=2, image_size=48,
                                device="cpu")
    return str(root)


def _records(path):
    return [json.loads(line) for line in open(join(path, "metrics.jsonl"))]


def _saved(path, epoch):
    return torch.load(join(ckpt.ckpt_dir(path, epoch), ckpt.TRAIN_NAME), weights_only=True)


def test_train_multi_4_subjects_dp2_resume_eval(datasets, tmp_path, capfd):
    out = str(tmp_path / "multi")
    sources = [join(datasets, n) for n in FRAMES]
    args = ["--sources", *sources, "-m", out, *SMALL_ARGS, "--batch_size", "2", "--dp", "2",
            "--pose_op_start_iter", "0"]
    train_multi.main([*args, "--epochs", "2", "--save_epochs", "0"], timeout_s=JOIN_TIMEOUT_S)
    printed = capfd.readouterr().out
    assert "data-parallel: 2 ranks over gloo" in printed
    assert "4 subjects x dp 2" in printed and "loss/subject" in printed
    # the fewest steps of any subject: 4 frames / batch 2 = 2 steps an epoch
    for name in FRAMES:
        d = join(out, name)
        assert os.path.exists(join(d, "cfg_args.json")), name
        assert os.path.exists(join(d, "log", "00001_pred.png")), name
        saved = _saved(d, 2)
        assert saved["iteration"] == 4 and saved["optimizer"]["net"]["count"] == 4, name
        net = torch.load(join(ckpt.ckpt_dir(d, 2), ckpt.CKPT_NAME), weights_only=True)
        assert net["pose_embedding"].shape[0] == FRAMES[name]   # its own rows, no padding
        records = _records(d)
        steps = [r for r in records if "step" in r]
        assert [r["step"] for r in steps] == [1] and np.isfinite(steps[0]["total"])
        events = {r["event"]: r["value"] for r in records if "event" in r}
        # CPU: plain versions, so no kernel of the port launched
        assert events["kernel_launches"] == {name: 0 for name in cuda_build.SOURCES}
    # subjects differ, so do their losses
    first = [_records(join(out, n))[0]["total"] for n in FRAMES]
    assert len(set(first)) == len(first)

    # resume every subject from its epoch-2 save
    train_multi.main([*args, "--epochs", "3", "--save_epochs", "0", "--checkpoint_epochs", "2"],
                     timeout_s=JOIN_TIMEOUT_S)
    assert "resumed 4 subjects from epoch 2 at iteration 4" in capfd.readouterr().out
    for name in FRAMES:
        saved = _saved(join(out, name), 3)
        assert saved["iteration"] == 6 and saved["optimizer"]["net"]["count"] == 6, name
        assert int(saved["optimizer"]["embed"]["step_count"]) == 6, name

    # a subject's save is a plain single-subject save
    result = eval_cli.main(["-m", join(out, "subjB"), "--device", "cpu"])
    assert result["frames"] == 2 and np.isfinite(result["psnr"])
    assert "psnr:" in open(join(out, "subjB", "test_free", "results.txt")).read()


def _bn_absorbed_bias(name):
    """A decoder Dense bias that feeds a BatchNorm: its true gradient is 0,
    so Adam turns float noise into steps of up to lr, and the running mean
    of the BatchNorm it feeds follows it (neither moves the output)."""
    return (name.startswith("pop.decoder.dense.") and name.endswith(".bias")
            and name.split(".")[3] not in ("7", "10", "13")) or name.endswith("running_mean")


def _rank_without_grad_sync(args, cfg):
    """A rank of `train --dp` whose gradients are not all-reduced: the
    control that shows the bounds below see a broken step."""
    with mock.patch.object(mesh, "all_reduce_grads", lambda params, grp: None):
        train.run_training(args, cfg)


def _dp_deviation(out1, out2):
    """How far run out2 left run out1: the largest difference of a logged
    term over the logged steps, relative to the step's total loss in out1
    (the small regularisers' own float noise aside), and the largest
    absolute difference
    of a parameter or BatchNorm variance (the BatchNorm-absorbed biases and
    the running means aside) and of an optimizer moment in the epoch-2
    save."""
    logged = [[r for r in _records(out) if "step" in r] for out in (out1, out2)]
    assert [r["step"] for r in logged[0]] == [r["step"] for r in logged[1]] == [1, 10]
    loss = max(abs(b[k] - a[k]) / abs(a["total"]) for a, b in zip(*logged)
               for k in ("total", "l1", "ssim", "scale", "offset", "geo"))
    (net1, tr1), (net2, tr2) = ((torch.load(join(ckpt.ckpt_dir(out, 2), ckpt.CKPT_NAME),
                                            weights_only=True), _saved(out, 2))
                                for out in (out1, out2))
    assert tr2["iteration"] == 6 and net1.keys() == net2.keys()
    held = [k for k in net1 if not _bn_absorbed_bias(k)]
    assert "geo_feature" in held and "pop.decoder.bn.0.running_var" in held
    params = max(float((net2[k] - net1[k]).abs().max()) for k in held)
    moments = [(tr1["optimizer"][g][m], tr2["optimizer"][g][m])
               for g in ("net", "geo", "embed") for m in ("mu", "nu")]
    assert all(m1 and m1.keys() == m2.keys() for m1, m2 in moments)
    moment = max(float((m2[k] - m1[k]).abs().max()) for m1, m2 in moments for k in m1)
    return {"loss": loss, "params": params, "moments": moment}


def test_train_dp2_matches_dp1_then_resume_and_eval(datasets, tmp_path, capfd):
    """The dp run sees the dp = 1 run's frames in the same order and takes
    the same steps (the CPU adds in order; only the mean of the ranks'
    means against one mean differs). Over 4 epochs (12 steps): every logged
    term (steps 1 and 10) is the dp = 1 run's to 1e-6 of the loss; in the
    epoch-2 save the parameters and BatchNorm variances to 1e-4 (Adam's
    steps on gradients near 0 amplify that noise, to 1.2e-5 in one element
    of a geometry conv) and the optimizer moments to 1e-5. A run whose
    ranks skip the gradient all-reduce misses all three. Rank 0 alone
    writes, and the save resumes and evaluates."""
    data = join(datasets, "subjA")
    base = ["-s", data, *SMALL_ARGS, "--batch_size", "2", "--no_lpips",
            "--pose_op_start_iter", "0", "--epochs", "4", "--save_epochs", "0", "--save_epoch", "2"]
    runs = {}
    for dp in (1, 2):
        out = str(tmp_path / f"dp{dp}")
        train.main(base + ["-m", out, "--dp", str(dp)], timeout_s=JOIN_TIMEOUT_S)
        runs[dp] = out
    assert "data-parallel: 2 ranks over gloo" in capfd.readouterr().out
    control = str(tmp_path / "dp2_no_grad_sync")
    mesh.spawn_ranks(_rank_without_grad_sync, 2, "cpu",
                     train.parse_args(base + ["-m", control, "--dp", "2"]),
                     timeout_s=JOIN_TIMEOUT_S)
    bounds = {"loss": 1e-6, "params": 1e-4, "moments": 1e-5}
    sound, broken = _dp_deviation(runs[1], runs[2]), _dp_deviation(runs[1], control)
    assert all(sound[k] <= bounds[k] < broken[k] for k in bounds), (sound, broken)
    # 6 frames / batch 2: 3 steps an epoch
    assert _saved(runs[2], 4)["iteration"] == 12
    assert [r["event"] for r in _records(runs[2]) if "event" in r] == ["lpips",
                                                                       "kernel_launches"]

    train.main(base + ["-m", runs[2], "--dp", "2", "--epochs", "5", "--checkpoint_epochs", "4"],
               timeout_s=JOIN_TIMEOUT_S)
    assert "resumed from epoch 4 at iteration 12" in capfd.readouterr().out
    saved = _saved(runs[2], 5)
    assert saved["iteration"] == 15 and saved["optimizer"]["geo"]["count"] == 15
    result = eval_cli.main(["-m", runs[2], "--device", "cpu"])
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])


def test_train_multi_stage2_boots_every_subject_from_one_save(datasets, tmp_path, capfd):
    """Stage 2 under train_multi takes the one --stage1_out_path for every
    subject, as the JAX loop does: pop, geo_feature and the per-frame
    embeddings of that save, whoever it was trained on, and says so
    (ROADMAP F14). A subject of another frame count cannot take the save's
    embedding rows and is refused."""
    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames

    data = {n: str(tmp_path / n) for n in ("subjB", "subjC", "subjA")}
    for n, d in data.items():
        shutil.copytree(join(datasets, n), d)
    out1 = str(tmp_path / "stage1")
    sources = [data["subjB"], data["subjC"]]
    # the stage-2 pose encoder halves its input five times: 32 px posmaps
    small = [*SMALL_ARGS, "--inp_posmap_size", "32", "--batch_size", "2"]
    train_multi.main(["--sources", *sources, "-m", out1, *small, "--epochs", "1",
                      "--save_epochs", "0"])
    for n, d in data.items():
        if n != "subjA":
            export_stage_1.main(["-m", join(out1, n), "-s", d, "--device", "cpu"])
        else:  # subjA was not trained: its own poses stand in for the refined ones
            shutil.copy(join(d, "train", "smpl_parms.pth"),
                        join(d, "train", "smpl_parms_pred.pth"))
            shutil.copy(join(d, "test", "smpl_parms.pth"), join(d, "test", "smpl_parms_pred.pth"))
        gen_pose_map_frames.main(["--source_path", d, "--synthetic", "--size", "32",
                                  "--device", "cpu"])
    stage1 = ckpt.ckpt_dir(join(out1, "subjB"), 1)
    out2 = str(tmp_path / "stage2")
    args = [*small, "--train_stage", "2", "--stage1_out_path", stage1, "--epochs", "1",
            "--save_epochs", "0"]
    capfd.readouterr()
    train_multi.main(["--sources", *sources, "-m", out2, *args])
    printed = capfd.readouterr().out
    assert "every subject boots stage 2 from the one stage-1 save" in printed
    assert "ROADMAP F14" in printed
    b1 = torch.load(join(stage1, ckpt.CKPT_NAME), weights_only=True)
    for n in ("subjB", "subjC"):
        net = torch.load(join(ckpt.ckpt_dir(join(out2, n), 1), ckpt.CKPT_NAME),
                         weights_only=True)
        # frozen in stage 2: subjC keeps subjB's stage-1 embeddings, as in JAX
        assert torch.equal(net["pose_embedding"], b1["pose_embedding"]), n
        assert torch.equal(net["geo_feature"], b1["geo_feature"]), n
        assert any(k.startswith("pose_encoder.") for k in net)
    with pytest.raises(ValueError, match="another frame count"):
        train_multi.main(["--sources", data["subjA"], data["subjB"], "-m",
                          str(tmp_path / "stage2_bad"), *args])


@pytest.mark.parametrize("cli", ["train", "train_multi"])
def test_dp_must_divide_the_batch(datasets, tmp_path, cli):
    """The JAX CLI's check and message, before any rank starts."""
    data = join(datasets, "subjB")
    if cli == "train":
        call = lambda extra: train.main(["-s", data, "-m", str(tmp_path / "o"), *SMALL_ARGS,
                                         *extra])
    else:
        call = lambda extra: train_multi.main(["--sources", data, data, "-m",
                                               str(tmp_path / "o"), *SMALL_ARGS, *extra])
    for extra in (["--batch_size", "3", "--dp", "2"], ["--batch_size", "2", "--dp", "4"]):
        with pytest.raises(ValueError, match=r"--batch_size \(\d\) must be a multiple of "
                                             r"--dp \(\d\)"):
            call(extra)
    assert not os.path.exists(tmp_path / "o")


def test_subjects_must_share_atlas_and_image_size(datasets, tmp_path):
    """The JAX multi-subject loop's refusals, with its messages."""
    from gaussianavatar_torch.config import build_parser, extract_config
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine.multi_loop import build_subjects

    def cfg(src, *extra):
        c = extract_config(build_parser().parse_args(["-s", src, *SMALL_ARGS[:-2], *extra]))
        c.model.model_path = str(tmp_path / "x")
        return c

    a, b = join(datasets, "subjB"), join(datasets, "subjC")
    with pytest.raises(ValueError, match="subjects must share a UV atlas"):
        build_subjects([cfg(a), cfg(b, "--query_posmap_size", "16")], "cpu")
    small = str(tmp_path / "small")
    write_synthetic_dataset(small, n_train=4, n_test=1, image_size=32, device="cpu")
    with pytest.raises(ValueError, match=r"subjects must share the image size "
                                         r"\(\(32, 32\) vs \(48, 48\)\)"):
        train_multi.main(["--sources", a, small, "-m", str(tmp_path / "o"), *SMALL_ARGS])


def test_subject_names_suffix_collisions():
    assert train_multi.subject_names(["/d/a", "/e/a/", "/f/b", "/g/a"]) == \
        ["a", "a_1", "b", "a_2"]
