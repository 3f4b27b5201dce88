"""The port's policy network, checkpoints and `Raptor` API held to the JAX
package, on the CPU.

The committed student `artifacts/student_rateFlagCurMix.h5` carries golden
I/O written on a TPU: replayed in float32 on the CPU, the JAX package itself
misses it by 1.2e-3 over the 500-step recurrent unroll. So the port is held
to the JAX package's own CPU replay at 1e-5, and to the embedded output no
worse than the JAX package is; checkpoints written on the CPU replay at 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from raptor_tpu.checkpoint import h5 as jh5
from raptor_tpu.ops import pallas_collect
from raptor_tpu.policy import network as jnet
from raptor_tpu.policy.raptor import Raptor as JRaptor
from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy import network, raptor
from raptor_tpu_torch.policy.entry import entry
from raptor_tpu_torch.policy.raptor import Raptor

H5 = "artifacts/student_rateFlagCurMix.h5"
NPZ = "raptor_tpu_torch/data/student_rateFlagCurMix.npz"


@pytest.fixture(scope="module")
def student():
    p = h5.load_actor(H5)
    return p, from_numpy(p, "cpu")


def test_golden_example_io(student):
    p_np, p_t = student
    ex_in, ex_out = h5.load_example_io(H5)
    with torch.no_grad():
        _, ours = network.apply_sequence(p_t, torch.from_numpy(ex_in))
    ours = ours.numpy()
    _, ref = jnet.apply_sequence(p_np, ex_in)  # highest matmul precision (conftest)
    ref = np.asarray(ref)
    assert np.max(np.abs(ours - ref)) <= 1e-5
    jax_err = np.max(np.abs(ref - ex_out))
    assert np.max(np.abs(ours - ex_out)) <= jax_err + 1e-5


def test_npz_equals_h5(tmp_path):
    a, b = h5.load_actor(H5), h5.load_actor(NPZ)
    assert a.keys() == b.keys()
    for layer in a:
        assert a[layer].keys() == b[layer].keys()
        for k in a[layer]:
            np.testing.assert_array_equal(a[layer][k], b[layer][k], f"{layer}/{k}")
    for x, y in zip(h5.load_example_io(H5), h5.load_example_io(NPZ)):
        np.testing.assert_array_equal(x, y)
    # the JAX loader reads the same arrays from the .h5
    jp = jh5.load_actor(H5)
    for layer in a:
        for k in a[layer]:
            np.testing.assert_array_equal(a[layer][k], jp[layer][k])
    # the committed file is what `to_npz` writes today
    h5.main([H5, str(tmp_path / "s.npz")])
    with np.load(tmp_path / "s.npz") as fresh, np.load(NPZ) as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], k)


def test_apply_step_matches_jax(student):
    p_np, p_t = student
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(8, 22)).astype(np.float32)
    h = rng.normal(size=(8, 16)).astype(np.float32)
    h_t, a_t = network.apply_step(p_t, torch.from_numpy(h), torch.from_numpy(obs))
    h_j, a_j = jnet.apply_step(p_np, h, obs)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
    np.testing.assert_array_equal(
        network.initial_hidden(p_t, 3).numpy(), np.asarray(jnet.initial_hidden(p_np, 3))
    )


def test_init_params_fold_norm_and_count(student):
    p_np, p_t = student
    fresh = network.init_params(torch.Generator().manual_seed(0))
    ref = jnet.init_params(jax.random.key(0))
    for layer in ref:
        for k in ref[layer]:
            assert tuple(fresh[layer][k].shape) == ref[layer][k].shape
            bound = 1.0 / np.sqrt(ref[layer][k].shape[-1]) if k.startswith("weights") else 0.0
            assert float(fresh[layer][k].abs().max()) <= bound
    assert network.num_params(fresh) == jnet.num_params(ref) == 2084
    rng = np.random.default_rng(1)
    mean = rng.normal(size=22).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=22).astype(np.float32)
    folded_t = network.fold_norm(p_t, torch.from_numpy(mean), torch.from_numpy(std))
    folded_j = jnet.fold_norm(p_np, mean, std)
    for k in ("weights", "biases"):
        np.testing.assert_allclose(
            folded_t["dense_0"][k].numpy(), np.asarray(folded_j["dense_0"][k]), atol=1e-6
        )


def test_flatten_policy_matches_pallas_layout(student):
    p_np, p_t = student
    flat = ops_eval.flatten_policy(p_t)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(pallas_collect.flatten_policy(p_np)).reshape(-1)
    )
    back = ops_eval.unflatten_policy(flat)
    for layer in p_t:
        for k in p_t[layer]:
            np.testing.assert_array_equal(back[layer][k].numpy(), p_t[layer][k].numpy())


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_save_actor_roundtrip_self_verifies(student, tmp_path, suffix):
    _, p_t = student
    path = str(tmp_path / f"ckpt{suffix}")
    h5.save_actor(path, p_t, checkpoint_name="roundtrip")
    assert h5.verify_checkpoint(path) <= 1e-5
    back = h5.load_actor(path)
    for layer in p_t:
        for k in p_t[layer]:
            np.testing.assert_array_equal(back[layer][k], p_t[layer][k].numpy())
    if suffix == ".h5":  # the reference schema: the JAX package reads it back
        assert jh5.verify_checkpoint(path) <= 1e-5
    with pytest.raises(ValueError):
        h5.save_actor(path, p_t, example_output=np.zeros((500, 2, 4), np.float32))
        h5.verify_checkpoint(path)


def test_raptor_matches_jax_raptor():
    ours = Raptor(H5, batch_size=3, device="cpu")
    ref = JRaptor(H5, batch_size=3)
    rng = np.random.default_rng(2)
    for _ in range(10):
        obs = rng.normal(size=(3, 22)).astype(np.float32)
        np.testing.assert_allclose(ours.evaluate_step(obs), ref.evaluate_step(obs), atol=1e-5)
    one = rng.normal(size=22).astype(np.float32)  # batch resize + squeeze
    a, b = ours.evaluate_step(one), ref.evaluate_step(one)
    assert a.shape == b.shape == (4,)
    np.testing.assert_allclose(a, b, atol=1e-6)
    ours.reset()
    np.testing.assert_array_equal(
        ours.hidden.numpy(), np.asarray(jnet.initial_hidden(h5.load_actor(H5), 1))
    )


def test_shipped_checkpoint_raises_when_reference_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(raptor, "_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("RAPTOR_REFERENCE_DIR", raising=False)
    with pytest.raises(FileNotFoundError):
        raptor.shipped_checkpoint_path()
    monkeypatch.setenv("RAPTOR_REFERENCE_DIR", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        raptor.shipped_checkpoint_path()
    assert not os.path.exists(tmp_path / "cache")


def test_entry_twin_matches_jax_entry():
    jfn, (jparams, jh, jobs) = jax_entry.entry()
    fn, (params, h, obs) = entry(device="cpu")
    assert obs.shape == tuple(jobs.shape) == (256, 22) and h.shape == tuple(jh.shape)
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in params.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in jparams.items()}
    # the JAX example arguments (and a non-trivial observation) through both
    rng = np.random.default_rng(0)
    p_np = jax.tree.map(np.asarray, jparams)
    for o in (np.asarray(jobs), rng.standard_normal((256, 22)).astype(np.float32)):
        ref = np.asarray(jfn(jparams, jh, jnp.asarray(o)))
        got = fn(from_numpy(p_np, "cpu"), torch.from_numpy(np.array(jh)), torch.from_numpy(np.array(o)))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert fn(params, h, obs).shape == (256, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()  # the default device is the card
