"""The port's forgetting A/B (``dskd_tpu_torch.tools.ab_forgetting``)
against the JAX tool (``tools/ab_forgetting.py``), on the CPU.

Both sides draw the same numpy batches and start from one JAX init
(``model.init(PRNGKey(0))``, carried to the port by
``state_dict_from_jax``). A few-step A/B (3 task-1 steps, then 3 distill
and 3 fine-tune steps, "hard + teacher-first + soft" / "corr + fg_info +
decode_v1") holds every loss row to JAX's, within 1e-4 on the run's first
step and 1e-3 after an update (1e-5 absolute: the f32 resolution of a KL
between equal maps), and the three ``eval_split_map`` results within
1e-3. The pinned 400/600 A/B with tests/test_forgetting_ab.py's
asserts runs on the port too, marked slow as JAX's is.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.tools import ab_forgetting as TA
from dskd_tpu_torch.tools import sweep_forgetting as TS
from dskd_tpu_torch.utils.weights import state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import ab_forgetting as JA  # noqa: E402  (the JAX tool)

torch.set_num_threads(1)

RECIPE = dict(cates_distill="hard + teacher-first + soft",
              feats_distill="corr + fg_info + decode_v1",
              teacher_score_thr=0.3)
MAPS = ("teacher_old", "teacher_new", "distill_old", "distill_new",
        "finetune_old", "finetune_new")


def jax_init_state(seed=0, H=128, W=128):
    """The JAX tool's initial weights, as a port state dict."""
    from dskd_tpu.models.detector import GFLDeformableDETR as JaxDETR

    model = JaxDETR(num_encoder_layers=1, num_decoder_layers=1,
                    num_query=40, depth=18, num_classes=JA.NUM_CLS)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
                           jnp.asarray([[H, W]], jnp.int32))
    return state_dict_from_jax(variables)


def test_synth_batch_and_constants_match_jax():
    assert (TA.NUM_CLS, TA.OLD, TA.NEW) == (JA.NUM_CLS, JA.OLD, JA.NEW)
    np.testing.assert_array_equal(TA.PALETTE, JA.PALETTE)
    for args in ((100, 2, 128, 128, 6, TA.OLD, TA.OLD),
                 (2003, 2, 128, 128, 6, range(4), TA.NEW),
                 (50_001, 1, 128, 128, 3, range(4), range(4))):
        for got, want in zip(TA.synth_batch(*args), JA.synth_batch(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert TS.VARIANTS.keys() == {
        "ref", "ref+soft", "ref@thr.05", "ref@600", "ref+soft@600",
        "ref+soft@600/400", "ref@600/400", "ref@1200/400"}


def test_few_step_ab_matches_jax(monkeypatch):
    import dskd_tpu.train.step as jstep

    want_rows = []
    make_step = jstep.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, batch, teacher_vars=None):
            state, losses = step(state, batch, teacher_vars)
            want_rows.append({k: float(v) for k, v in losses.items()})
            return state, losses
        return run

    monkeypatch.setattr(jstep, "make_train_step", recording)
    want = JA.run_forgetting_ab(3, 3, n_eval=3, **RECIPE)
    rows = {}
    got = TA.run_forgetting_ab(3, 3, n_eval=3, device="cpu",
                               init_state=jax_init_state(), rows=rows,
                               **RECIPE)
    got_rows = rows["task1"] + rows["distill"] + rows["finetune"]
    assert len(got_rows) == len(want_rows) == 9
    assert "loss_kd" in got_rows[3] and "loss_fg_feature" in got_rows[3]
    for i, (g, w) in enumerate(zip(got_rows, want_rows)):
        assert sorted(g) == sorted(w), i
        # f32 through a whole model: 1e-4 relative from equal weights, 1e-3
        # after an update. The distill phase starts the student from the
        # teacher's weights, so its fg KL compares equal maps: 0 in exact
        # arithmetic, ~4e-6 of f32 cancellation over order-1 log terms in
        # either framework; 1e-5 absolute is that resolution.
        rtol = 1e-4 if i == 0 else 1e-3
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=rtol, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    for k in MAPS:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert got["wall_s"] > 0 and got["distill_ms"] > 0


def test_ab_cli_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.main(["1", "1"])
    with pytest.raises(SystemExit):
        TS.main(["no-such-variant", "--device", "cpu"])


def test_sweep_runs_each_seed_and_prints_their_mean(monkeypatch, capsys):
    """One SWEEP line per seed (its seed in it), then SWEEP_MEAN with the
    mean and sample sd of each mAP; TF32 is off afterwards."""
    import json

    seen = []

    def fake(steps1, steps2, seed, device, **kw):
        seen.append((steps1, steps2, seed, device))
        r = dict.fromkeys(MAPS, float(seed))
        return dict(r, distill_new=10.0 * seed, task1_ms=1.0,
                    distill_ms=1.0, finetune_ms=1.0, wall_s=1.0)

    monkeypatch.setattr(TS, "run_forgetting_ab", fake)
    # restored after the test: main turns TF32 off for the process
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert TS.main(["ref+soft@600/400", "--device", "cpu",
                    "--seed", "1", "3"]) == 0
    assert seen == [(400, 600, 1, "cpu"), (400, 600, 3, "cpu")]
    lines = capsys.readouterr().out.splitlines()
    runs = [json.loads(ln[6:]) for ln in lines if ln.startswith("SWEEP ")]
    assert [r["seed"] for r in runs] == [1, 3]
    mean = json.loads([ln for ln in lines
                       if ln.startswith("SWEEP_MEAN ")][0][11:])
    assert mean["n"] == 2 and mean["variant"] == "ref+soft@600/400"
    assert mean["teacher_old"] == {"mean": 2.0, "sd": 2 ** 0.5}
    assert mean["distill_new"] == {"mean": 20.0, "sd": 200 ** 0.5}
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.slow
def test_port_distill_beats_finetune_on_combined_map():
    """tests/test_forgetting_ab.py's pinned A/B and asserts, on the port."""
    r = TA.run_forgetting_ab(steps1=400, steps2=600, B=2, H=128, W=128,
                             G=6, n_eval=12, device="cpu",
                             init_state=jax_init_state(), **RECIPE)
    assert r["teacher_old"] > 25.0, r
    assert r["distill_old"] > r["finetune_old"] + 10.0, r
    assert r["distill_old"] > 0.6 * r["teacher_old"], r
    assert r["distill_new"] > 0.6 * r["finetune_new"], r
    assert r["finetune_old"] < 0.25 * r["teacher_old"], r
    assert (r["distill_old"] + r["distill_new"]
            > r["finetune_old"] + r["finetune_new"] + 5.0), r
    assert all(TA.margins(r).values()), r
