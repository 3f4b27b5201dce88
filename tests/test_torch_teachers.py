"""The port's teacher gate on the CPU, against the JAX package:

- `apps.eval_teachers.evaluate_pack` against the JAX CLI's per-member
  evaluation, from the initial states the JAX evaluation draws from its keys
  (the committed packs' airframes carry zero disturbance, so no step draws
  noise and both packages fly the same trajectories);
- the two CLIs' reports have the same keys in the same order;
- `chip_smoke.gate_agreement`, the card's hold on the gate, passes the
  port's own CPU gate and the committed report and refuses a gate that never
  terminates;
- `apps.filter_teachers` on each pack of the flagship recipe with its
  committed report reproduces the committed hover-gated pack array for array,
  as the JAX package's `filter_pack` does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raptor_tpu.apps import eval_teachers as j_eval_teachers
from raptor_tpu.apps import filter_teachers as j_filter_teachers
from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env.types import DynamicsParams as JDynamicsParams
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.rl import evaluation as jevaluation
from raptor_tpu_torch.apps import eval_teachers, filter_teachers
from raptor_tpu_torch.apps.pack_teachers import load_teacher_pack, save_teacher_pack
from raptor_tpu_torch.checkpoint import teachers_from_numpy, state_from_numpy
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each pack of experiments/union_cur691_packs.txt: (source pack, report)
GATED = {
    "seed900": ("artifacts/teachers_seed900_30M.npz", "artifacts/eval_teachers_hover02b.json"),
    "seed1000": ("artifacts/teachers_seed1000_30M.npz", "artifacts/eval_teachers_hover02.json"),
    "seed1100": ("artifacts/teachers_seed1100_30M.npz", "artifacts/eval_teachers_hover02b.json"),
    "seed1200": ("artifacts/teachers_seed1200_30M.npz", "artifacts/eval_teachers_hover02b.json"),
    "rec2100": ("artifacts/teachers_rec2100_15M.npz", "artifacts/eval_teachers_hover02b.json"),
    "demo2500": ("artifacts/teachers_demo2500_30M.npz", "artifacts/eval_teachers_hover02.json"),
}


def _subset(pack, teachers):
    actors, frames = load_teacher_pack(os.path.join(ROOT, pack))
    return ({"layers": [{kk: v[teachers] for kk, v in layer.items()}
                        for layer in actors["layers"]]},
            {f: v[teachers] for f, v in frames.items()})


@pytest.mark.parametrize("pack, teachers, steps", [
    ("seed1000", [0, 1, 2], 60),
    # teachers 5 and 24 of seed900: the committed report rejects both outright
    ("seed900", [0, 5, 24], 120),
], ids=["hover", "terminating"])
def test_evaluate_pack_matches_jax_from_handed_initial_states(pack, teachers, steps):
    """3 teachers x 2 episodes at the gate's 0.2 rad: per-teacher stats at
    rtol/atol 1e-4; the second case holds a termination too."""
    k, episodes, seed = len(teachers), 2, 0
    actors_np, frames_np = _subset(GATED[pack][0], teachers)
    assert all(float(np.abs(frames_np[f]).max()) == 0.0
               for f in ("disturbance_force_std", "disturbance_torque_std"))
    cfg = dict(episode_length=steps)
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=0.2), **cfg))
    env = L2F(EnvConfig(init=InitConfig(max_angle=0.2), **cfg))
    jair = JDynamicsParams(**{f: jnp.asarray(v) for f, v in frames_np.items()})
    jactors = jax.tree.map(jnp.asarray, actors_np)

    def member_eval(actor, airframe, key):  # raptor_tpu/apps/eval_teachers.py
        p_eval = jax.tree.map(lambda x: jnp.broadcast_to(x, (episodes,) + x.shape), airframe)
        step_fn, carry = jevaluation.mlp_policy_step(actor)
        return jevaluation.evaluate(jenv, p_eval, step_fn, carry, key, episodes,
                                    jenv.EPISODE_LENGTH)

    def initial(airframe, key):  # as evaluation.evaluate resets
        p = jax.tree.map(lambda x: jnp.broadcast_to(x, (episodes,) + x.shape), airframe)
        return jax.vmap(jenv.reset)(jax.random.split(key, episodes), p)[0].dynamics

    keys = jax.random.split(jax.random.key(seed), k)
    with jax.default_matmul_precision("highest"):
        ref = jax.vmap(member_eval)(jactors, jair, keys)
    state0 = state_from_numpy(jax.tree.map(
        lambda x: np.asarray(x).reshape(k * episodes, *x.shape[2:]),
        jax.vmap(initial)(jair, keys)), "cpu")
    actors, airframes = teachers_from_numpy(actors_np, frames_np, "cpu")
    got = eval_teachers.evaluate_pack(env, actors, airframes, episodes, torch.Generator(),
                                      state=state0)
    np.testing.assert_allclose(got["per_teacher_return"], np.asarray(ref.return_mean),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["per_teacher_share_terminated"],
                               np.asarray(ref.share_terminated), rtol=1e-4, atol=1e-4)
    assert got["episode_length/mean"] == pytest.approx(
        float(np.asarray(ref.episode_length_mean).mean()), rel=1e-4, abs=1e-4)
    assert got["teachers"] == k and got["episodes_per_teacher"] == episodes
    assert min(got["per_teacher_return"]) > 0  # the gate's teachers fly
    if pack == "seed900":
        assert float(np.asarray(ref.share_terminated).max()) > 0


def test_reports_of_the_two_clis_have_the_same_keys(tmp_path):
    """Both CLIs on a 3-teacher pack, one episode each: one entry keyed by the
    path as given, the same keys in the same order, the same shapes."""
    actors_np, frames_np = _subset(GATED["seed900"][0], [0, 1, 2])
    pack = str(tmp_path / "three.npz")
    save_teacher_pack(pack, actors_np, frames_np)
    args = [pack, "--episodes", "1", "--max-angle", "0.2"]
    got = eval_teachers.main([*args, "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    j_eval_teachers.main([*args, "--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert list(got) == list(want) == [pack]
    assert list(got[pack]) == list(want[pack])
    for key, value in want[pack].items():
        assert type(got[pack][key]) is type(value), key
        if isinstance(value, list):
            assert len(got[pack][key]) == len(value) == 3
    assert all(np.isfinite(v) for v in got[pack]["per_teacher_return"])


@pytest.mark.parametrize("name", list(GATED))
def test_filter_reproduces_the_committed_hovergate_pack(name, tmp_path, capsys, monkeypatch):
    """Run from the repo root with the relative paths the reports key by."""
    pack, report = GATED[name]
    monkeypatch.chdir(ROOT)
    out, jout = tmp_path / "port.npz", tmp_path / "jax.npz"
    flags = ["--eval", report, "--max-term", "0.5"]
    kept = filter_teachers.main([pack, str(out), *flags])
    assert capsys.readouterr().out.startswith(f"{pack}: kept {kept}/128 -> ")
    j_filter_teachers.main([pack, str(jout), *flags])
    committed = f"artifacts/teachers_{name}_hovergate.npz"
    with np.load(out) as got, np.load(jout) as j, np.load(committed) as want:
        assert sorted(got.files) == sorted(want.files) == sorted(j.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            np.testing.assert_array_equal(got[key], j[key], err_msg=key)
        meta = json.loads(bytes(got["meta"]).decode())
    assert meta["n_teachers"] == kept and meta["filtered_from"] == pack


def test_filter_pack_checks_its_mask_and_the_report(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    pack, report = GATED["seed900"]
    with pytest.raises(ValueError, match="128 teachers"):
        filter_teachers.filter_pack(pack, str(tmp_path / "x.npz"), np.ones(5, bool), "")
    with pytest.raises(SystemExit, match="no entry"):
        filter_teachers.main(["artifacts/teachers_seed1300_30M.npz", str(tmp_path / "x.npz"),
                              "--eval", report])
    kept = filter_teachers.main([pack, str(tmp_path / "r.npz"), "--eval", report,
                                 "--min-return", "0"])
    ret = np.array(json.load(open(report))[pack]["per_teacher_return"])
    assert kept == int((ret >= 0).sum())


def test_gate_agreement_holds_the_cpu_gate_and_refuses_one_that_never_terminates(monkeypatch):
    """The port's gate of seed900 on the CPU (its own random stream, 128
    teachers x 4 envs x 500 steps) passes chip_smoke.py's phase-16 check; an
    evaluation that never reports a termination keeps all 128 teachers and
    agrees on 89.8 %, over the 85 % bar, but is refused."""
    monkeypatch.chdir(ROOT)
    pack, report = GATED["seed900"]
    committed = json.load(open(report))[pack]["per_teacher_share_terminated"]
    assert chip_smoke.gate_agreement(committed, committed) == (115, 1.0, 0, [])
    got = eval_teachers.main([pack, "--episodes", "4", "--max-angle", "0.2", "--device", "cpu"])
    kept, agreement, clear, faults = chip_smoke.gate_agreement(
        got[pack]["per_teacher_share_terminated"], committed)
    assert faults == [] and agreement >= 0.85
    kept, agreement, clear, faults = chip_smoke.gate_agreement(np.zeros(128), committed)
    assert (kept, clear) == (128, 7) and agreement > 0.85
    assert len(faults) == 2
