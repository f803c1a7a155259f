"""The port's tasks and launcher (``deepfm_tpu_torch.train.tasks``,
``deepfm_tpu_torch.launch``) end to end on the CPU, at a small size: train
-> eval -> infer -> export, resume, the exported artifact served by the
port's serving loader, and the modes that are not ported yet.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepfm_tpu_torch import launch
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)

V, F = 300, 5


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ctr"))
    kw = dict(feature_size=V, field_size=F)
    libsvm.generate_synthetic_ctr(d, num_files=2, examples_per_file=300,
                                  seed=1, **kw)
    libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=150,
                                  seed=2, prefix="va", **kw)
    libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=70,
                                  seed=3, prefix="te", **kw)
    return d


def _cfg(data_dir, model_dir, task="train", **kw):
    base = dict(task_type=task, feature_size=V, field_size=F,
                embedding_size=4, deep_layers="16,8", dropout="0.5,0.5",
                batch_size=32, learning_rate=0.01, log_steps=5,
                steps_per_loop=4, num_epochs=2, shuffle_buffer=200,
                data_dir=data_dir, val_data_dir=data_dir,
                model_dir=os.path.join(model_dir, "ckpt"),
                servable_model_dir=os.path.join(model_dir, "servable"))
    base.update(kw)
    return Config(**base)


def test_train_eval_infer_export(data_dir, tmp_path):
    res = tasks.run(_cfg(data_dir, str(tmp_path)), device="cpu")
    steps = 2 * (600 // 32)
    assert res["steps"] == steps and np.isfinite(res["loss"])
    assert 0.5 < res["auc"] <= 1.0 and res["eval_loss"] > 0
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() == steps

    ev = tasks.run(_cfg(data_dir, str(tmp_path), "eval"), device="cpu")
    assert ev["auc"] == pytest.approx(res["auc"], abs=1e-6)
    assert ev["batches"] == 5.0  # 150 records: 4 full + a 22-row tail

    inf = tasks.run(_cfg(data_dir, str(tmp_path), "infer"), device="cpu")
    assert inf["num_predictions"] == 70.0
    preds = np.loadtxt(os.path.join(data_dir, "pred.txt"))
    assert preds.shape == (70,) and np.all((preds > 0) & (preds < 1))

    out = tasks.run(_cfg(data_dir, str(tmp_path), "export",
                         servable_model_dir=str(tmp_path / "sv2")),
                    device="cpu")
    assert out["step"] == steps
    artifact = str(tmp_path / "sv2" / str(steps))
    serve = export_lib.load_serving(artifact, device="cpu")
    cfg = _cfg(data_dir, str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    state = ckpt_lib.CheckpointManager(cfg.model_dir).restore(
        trainer.init_state())
    from deepfm_tpu_torch.data import pipeline
    batch = next(iter(pipeline.CtrPipeline(
        tasks.resolve_files(data_dir, "te"), field_size=F, batch_size=32,
        shuffle=False)))
    want = next(trainer.predict(state, [batch]))
    got = serve(batch["feat_ids"], batch["feat_vals"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(preds[:32], want, atol=1e-6)
    # train exported too, at its last step
    assert os.path.exists(os.path.join(
        str(tmp_path / "servable"), str(steps), export_lib.COMPLETE_MARKER))


def test_resume_mid_epoch_matches_uninterrupted_run(data_dir, tmp_path):
    """A run cut after the step-8 checkpoint resumes there, skips the 8
    batches it trained and ends bit-identical to the run that was never
    cut (CPU, the same sums in the same order)."""
    kw = dict(num_epochs=1, save_checkpoints_steps=4, keep_checkpoint_max=10,
              servable_model_dir="")
    full = _cfg(data_dir, str(tmp_path / "full"), **kw)
    tasks.run(full, device="cpu")
    cut = _cfg(data_dir, str(tmp_path / "cut"), **kw)
    tasks.run(cut, device="cpu")
    # Cut: keep checkpoints up to step 8 and the sidecar that step wrote.
    mgr = ckpt_lib.CheckpointManager(cut.model_dir)
    for s in mgr.all_steps():
        if s > 8:
            os.remove(os.path.join(cut.model_dir, f"ckpt-{s}.pt"))
    meta_path = os.path.join(cut.model_dir, "resume_meta.json")
    meta = json.load(open(meta_path))
    meta.update(step=8, steps_into_epoch=8, completed=False)
    json.dump(meta, open(meta_path, "w"))
    res = tasks.run(cut, device="cpu")
    assert res["steps"] == 600 // 32

    t = Trainer(full, device="cpu")
    a = ckpt_lib.CheckpointManager(full.model_dir).restore(t.init_state())
    b = ckpt_lib.CheckpointManager(cut.model_dir).restore(t.init_state())
    assert a.step == b.step == 600 // 32
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.opt_state["count"] == b.opt_state["count"]


def test_completed_run_resumes_for_more_epochs(data_dir, tmp_path):
    cfg = _cfg(data_dir, str(tmp_path), num_epochs=1, servable_model_dir="")
    first = tasks.run(cfg, device="cpu")
    second = tasks.run(cfg, device="cpu")
    assert second["steps"] == 2 * first["steps"]
    cleared = tasks.run(cfg.replace(clear_existing_model=True), device="cpu")
    assert cleared["steps"] == first["steps"]


def test_checkpoint_manager_keeps_newest_and_restores(tmp_path):
    cfg = _cfg("", str(tmp_path))
    t = Trainer(cfg, device="cpu")
    state = t.init_state()
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "m"), max_to_keep=2,
                                     save_interval_steps=5)
    for step in (5, 10, 15):
        state.step = step
        assert mgr.save(step, state)
    assert not mgr.save(15, state)
    assert mgr.all_steps() == [10, 15]
    assert [mgr.should_save(s) for s in (16, 19, 20, 26)] == [
        False, False, True, True]
    other = t.init_state(seed=99)
    mgr.restore(other)
    assert other.step == 15
    for k in state.params:
        assert torch.equal(other.params[k], state.params[k])
    assert torch.equal(other.rng.get_state(), state.rng.get_state())
    leftovers = [n for n in os.listdir(mgr.directory) if n.startswith(".tmp")]
    assert leftovers == []


def test_eval_infer_export_need_a_checkpoint(data_dir, tmp_path):
    for task in ("eval", "infer", "export"):
        with pytest.raises(FileNotFoundError, match="needs a checkpoint"):
            tasks.run(_cfg(data_dir, str(tmp_path), task), device="cpu")
    assert not os.path.exists(tmp_path / "ckpt")


@pytest.mark.parametrize("flag,value", [
    ("online_mode", True), ("pipe_mode", 1), ("device_dataset", True),
    ("publish_every_steps", 10), ("tensorboard_dir", "tb"),
    ("profile_dir", "prof"), ("mesh_model", 2), ("decoded_cache", "ram"),
    ("eval_throttle_secs", 5), ("grad_accum_steps", 2),
])
def test_unported_modes_raise_naming_their_flag(data_dir, tmp_path, flag,
                                                value):
    """Each mode the port has not reached raises naming its flag; gradient
    accumulation is ported, and its train task runs."""
    kw = {flag: value}
    named = flag
    if flag == "device_dataset":
        kw["decoded_cache"] = "ram"
    if flag == "grad_accum_steps":  # must divide steps_per_loop
        kw["steps_per_loop"] = 2
    if flag == "online_mode":
        kw.update(pipe_mode=1, num_epochs=1)
    if flag == "grad_accum_steps":
        res = tasks.run(_cfg(data_dir, str(tmp_path), num_epochs=1, **kw),
                        device="cpu")
        assert res["steps"] == 600 // 32 and np.isfinite(res["loss"])
        return
    with pytest.raises(NotImplementedError,
                       match=f"--{named}.* not yet ported"):
        tasks.run(_cfg(data_dir, str(tmp_path), **kw), device="cpu")


def test_cli_without_a_gpu_raises_instead_of_using_the_cpu(
        data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--task_type", "train", "--data_dir", data_dir,
            "--feature_size", str(V), "--field_size", str(F),
            "--model_dir", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(argv)
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_prints_the_result_line(data_dir, tmp_path, capsys):
    argv = ["--task_type", "train", "--data_dir", data_dir,
            "--val_data_dir", data_dir, "--feature_size", str(V),
            "--field_size", str(F), "--embedding_size", "4",
            "--deep_layers", "8", "--dropout", "0.5", "--batch_size", "64",
            "--num_epochs", "1", "--model_dir", str(tmp_path / "ckpt")]
    assert launch.main(argv, device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["task"] == "train" and out["steps"] == 600 // 64
    assert "auc" in out
