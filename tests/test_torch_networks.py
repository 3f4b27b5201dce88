"""The port's teacher side (`rl.networks`, `apps.pack_teachers`,
`apps.post_training.load_teachers`, `env.io`, `rl.evaluation.mlp_policy_step`)
held to the JAX package on inputs made with numpy from a seed and handed to
both.

Tolerance 1e-6 (absolute) on every network output of order 1: both sides
compute `x @ w + b` in f32 on the CPU and differ only in the order of the sums.
Loaders are compared field by field, exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.apps import pack_teachers as jpack
from raptor_tpu.apps import post_training as japp
from raptor_tpu.env import io as jio
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.rl import evaluation as jevaluation
from raptor_tpu.rl import networks as jnetworks
from raptor_tpu_torch.apps import pack_teachers, post_training
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, h5, teachers_from_numpy
from raptor_tpu_torch.env import io
from raptor_tpu_torch.rl import evaluation, networks

PACK = "artifacts/teachers_seed900_hovergate.npz"
PACK2 = "artifacts/teachers_seed1000_hovergate.npz"
ATOL = 1e-6


def mlp_np(rng, dims, stack=None):
    """MLP parameters as numpy arrays, with a leading [stack] axis if asked."""
    lead = () if stack is None else (stack,)
    return {"layers": [
        {"w": rng.normal(0, dims[i] ** -0.5, lead + (dims[i], dims[i + 1])).astype(np.float32),
         "b": rng.normal(0, 0.1, lead + (dims[i + 1],)).astype(np.float32)}
        for i in range(len(dims) - 1)
    ]}


def to_torch(p):
    return {"layers": [{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in p["layers"]]}


def test_mlp_apply_and_actor_match_jax():
    rng = np.random.default_rng(0)
    p = mlp_np(rng, [31, 64, 64, 8])
    x = rng.normal(0, 1, (5, 7, 31)).astype(np.float32)
    want = np.asarray(jnetworks.mlp_apply(p, jnp.asarray(x)))
    got = networks.mlp_apply(to_torch(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        networks.mlp_apply(to_torch(p), torch.from_numpy(x), torch.tanh).numpy(),
        np.asarray(jnetworks.mlp_apply(p, jnp.asarray(x), jnp.tanh)), atol=ATOL, rtol=0)
    # log_std is clipped into [LOG_STD_MIN, LOG_STD_MAX]: scale the head up so it is hit
    p["layers"][-1]["w"] *= 20.0
    mu_j, ls_j = jnetworks.actor_dist(p, jnp.asarray(x))
    mu_t, ls_t = networks.actor_dist(to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j), atol=2e-5, rtol=0)
    assert float(ls_t.max()) == networks.LOG_STD_MAX == jnetworks.LOG_STD_MAX
    assert float(ls_t.min()) == networks.LOG_STD_MIN == jnetworks.LOG_STD_MIN
    np.testing.assert_allclose(
        networks.actor_mean(to_torch(p), torch.from_numpy(x)).numpy(),
        np.asarray(jnetworks.actor_mean(p, jnp.asarray(x))), atol=ATOL, rtol=0)


def test_stacked_actors_match_vmap():
    """[K] stacked actors on [K, B, in] inputs: the batched matmul against
    `jax.vmap(actor_mean)`, and against K single applications."""
    rng = np.random.default_rng(1)
    k = 5
    p = mlp_np(rng, [31, 16, 16, 8], stack=k)
    x = rng.normal(0, 1, (k, 9, 31)).astype(np.float32)
    want = np.asarray(jax.vmap(jnetworks.actor_mean)(p, jnp.asarray(x)))
    pt = to_torch(p)
    got = networks.actor_mean(pt, torch.from_numpy(x))
    assert got.shape == (k, 9, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert networks.n_actors(pt) == k
    singles = [
        {"layers": [{n: v[i] for n, v in layer.items()} for layer in pt["layers"]]}
        for i in range(k)
    ]
    for i, single in enumerate(singles):
        np.testing.assert_allclose(
            networks.actor_mean(single, torch.from_numpy(x[i])).numpy(), want[i], atol=ATOL,
            rtol=0)
    restacked = networks.stack_actors(singles)
    taken = networks.take_actors(pt, torch.tensor([3, 0]))
    for a, b, c in zip(pt["layers"], restacked["layers"], taken["layers"]):
        for n in ("w", "b"):
            assert torch.equal(a[n], b[n]) and torch.equal(c[n], a[n][[3, 0]])


def test_init_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    p = networks.actor_init(g, 31, 4)
    jp = jnetworks.actor_init(jax.random.key(0), 31, 4)
    assert [tuple(layer["w"].shape) for layer in p["layers"]] == [
        tuple(layer["w"].shape) for layer in jp["layers"]]
    for layer, fan_in, scale in zip(p["layers"], (31, 64, 64), (1.0, 1.0, 0.01)):
        assert float(layer["w"].abs().max()) <= scale / np.sqrt(fan_in)
        assert float(layer["w"].abs().max()) > 0.8 * scale / np.sqrt(fan_in)
        assert float(layer["b"].abs().max()) == 0.0


def test_standardize_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(0, 1, (6, 11, 22)) * rng.uniform(0.1, 4, 22) + rng.normal(0, 2, 22)).astype(
        np.float32)
    sj = jnetworks.standardize_from_batch(jnp.asarray(x))
    st = networks.standardize_from_batch(torch.from_numpy(x))
    for n in ("mean", "std"):
        np.testing.assert_allclose(st[n].numpy(), np.asarray(sj[n]), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(
        networks.standardize_apply(st, torch.from_numpy(x)).numpy(),
        np.asarray(jnetworks.standardize_apply(sj, jnp.asarray(x))), atol=1e-5, rtol=0)
    ident = networks.standardize_init(22, "cpu")
    assert torch.equal(networks.standardize_apply(ident, torch.from_numpy(x)),
                       torch.from_numpy(x))
    dense = mlp_np(rng, [22, 16])["layers"][0]
    fj = jnetworks.fold_standardize_into_dense(sj, dense)
    ft = networks.fold_standardize_into_dense(st, to_torch({"layers": [dense]})["layers"][0])
    for n in ("w", "b"):
        np.testing.assert_allclose(ft[n].numpy(), np.asarray(fj[n]), atol=1e-5, rtol=1e-5)
    # folding is exact up to rounding: dense(standardize(x)) == folded(x)
    xt = torch.from_numpy(x)
    direct = networks.standardize_apply(st, xt) @ torch.from_numpy(dense["w"]) + torch.from_numpy(
        dense["b"])
    np.testing.assert_allclose((xt @ ft["w"] + ft["b"]).numpy(), direct.numpy(), atol=1e-4)


def test_mlp_policy_step_matches_jax():
    rng = np.random.default_rng(3)
    p = mlp_np(rng, [31, 16, 8])
    obs = rng.normal(0, 1, (6, 40)).astype(np.float32)
    step_j, carry_j = jevaluation.mlp_policy_step(p, 31)
    step_t, carry_t = evaluation.mlp_policy_step(to_torch(p), 31)
    assert carry_j == () and carry_t == ()
    cj, aj = step_j(carry_j, jnp.asarray(obs))
    ct, at = step_t(carry_t, torch.from_numpy(obs))
    assert ct == () and cj == ()
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=ATOL, rtol=0)
    full = mlp_np(rng, [40, 8])
    np.testing.assert_allclose(
        evaluation.mlp_policy_step(to_torch(full))[0]((), torch.from_numpy(obs))[1].numpy(),
        np.asarray(jevaluation.mlp_policy_step(full)[0]((), jnp.asarray(obs))[1]),
        atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def assert_population_equal(got, want):
    (actors_t, frames_t), (actors_j, frames_j) = got, want
    assert len(actors_t["layers"]) == len(actors_j["layers"])
    for lt, lj in zip(actors_t["layers"], actors_j["layers"]):
        for n in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(lt[n]), np.asarray(lj[n]))
    for f in jio._FIELDS:
        got_f = frames_t[f] if isinstance(frames_t, dict) else getattr(frames_t, f)
        np.testing.assert_array_equal(np.asarray(got_f), np.asarray(getattr(frames_j, f)), f)


def test_load_teacher_pack_equals_jax_loader():
    got = pack_teachers.load_teacher_pack(PACK)
    want = jpack.load_teacher_pack(PACK)
    assert_population_equal(got, want)
    assert io._FIELDS == jio._FIELDS
    assert pack_teachers.pack_info(PACK) == jpack.pack_info(PACK)
    actors, frames = teachers_from_numpy(*got, "cpu")
    k = pack_teachers.pack_info(PACK)["n_teachers"]
    assert networks.n_actors(actors) == k == frames.mass.shape[0]
    assert actors["layers"][0]["w"].dtype == torch.float32
    # the loaded population labels like the JAX one (1e-5: trained weights
    # give pre-activations of order 10, where an f32 ulp is 1e-6)
    obs = np.random.default_rng(4).normal(0, 1, (k, 3, 31)).astype(np.float32)
    np.testing.assert_allclose(
        networks.actor_mean(actors, torch.from_numpy(obs)).numpy(),
        np.asarray(jax.vmap(jnetworks.actor_mean)(want[0], jnp.asarray(obs))), atol=1e-5, rtol=0)


def test_save_teacher_pack_roundtrip(tmp_path):
    actors_np, frames_np = pack_teachers.load_teacher_pack(PACK)
    actors, frames = teachers_from_numpy(actors_np, frames_np, "cpu")
    sub = networks.take_actors(actors, torch.arange(3))
    path = str(tmp_path / "three.npz")
    pack_teachers.save_teacher_pack(
        path, sub, {f: getattr(frames, f)[:3] for f in io._FIELDS}, meta={"note": "x"})
    info = pack_teachers.pack_info(path)
    assert info["n_teachers"] == 3 and info["note"] == "x" and info["version"] == 1
    # the JAX loader reads what the port wrote
    jactors, jframes = jpack.load_teacher_pack(path)
    for lt, lj in zip(sub["layers"], jactors["layers"]):
        np.testing.assert_array_equal(lt["w"].numpy(), np.asarray(lj["w"]))
    np.testing.assert_array_equal(np.asarray(jframes.mass), frames_np["mass"][:3])


@pytest.mark.parametrize("fault", ["no_meta", "garbled_meta", "version", "count"])
def test_load_teacher_pack_rejects_corrupt_packs(tmp_path, fault):
    with np.load(PACK) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    if fault == "no_meta":
        del arrays["meta"]
        match = "no parseable meta"
    elif fault == "garbled_meta":
        arrays["meta"] = np.frombuffer(b"{not json", dtype=np.uint8)
        match = "no parseable meta"
    elif fault == "version":
        meta["version"] = 99
        match = "format version 99"
    else:
        meta["n_teachers"] += 1
        match = "arrays hold"
    if fault in ("version", "count"):
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match=match):
        pack_teachers.load_teacher_pack(path)
    with pytest.raises(ValueError):
        jpack.load_teacher_pack(path)  # the JAX loader refuses the same files


def test_load_teachers_concatenates_packs_in_line_order(tmp_path):
    manifest = tmp_path / "packs.txt"
    manifest.write_text(f"{PACK2}\n\n{PACK}\n")
    got = post_training.load_teachers(str(manifest), "cpu")
    want = japp.load_teachers(str(manifest))
    assert_population_equal(got, want)
    k2 = pack_teachers.pack_info(PACK2)["n_teachers"]
    first = pack_teachers.load_teacher_pack(PACK2)[1]["mass"]
    np.testing.assert_array_equal(got[1].mass[:k2].numpy(), first)
    assert got[1].mass.shape[0] == k2 + pack_teachers.pack_info(PACK)["n_teachers"]
    single = post_training.load_teachers(PACK, "cpu")
    assert_population_equal(single, jpack.load_teacher_pack(PACK))
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="is empty"):
        post_training.load_teachers(str(empty), "cpu")


def test_load_teachers_reads_h5_manifests_mixed_with_packs(tmp_path):
    """Per-teacher `.h5` actors with their `_dynamics.json`, written by the
    JAX package, mixed with a pack: the K axis follows the line order."""
    from raptor_tpu.checkpoint import h5 as jh5

    rng = np.random.default_rng(5)
    jframes = jsample(jax.random.key(2), 2)
    lines = []
    for i in range(2):
        actor = mlp_np(rng, [31, 64, 64, 8])
        path = str(tmp_path / f"teacher_{i}.h5")
        jh5.save_mlp_actor(path, actor)
        jio.save_params_json(path.replace(".h5", "_dynamics.json"),
                             jax.tree.map(lambda x: x[i], jframes))
        lines.append(path)
        loaded = h5.load_mlp_actor(path)
        for a, b in zip(loaded["layers"], actor["layers"]):
            np.testing.assert_array_equal(a["w"], b["w"])
            np.testing.assert_array_equal(a["b"], b["b"])
    manifest = tmp_path / "checkpoints.txt"
    manifest.write_text("\n".join([lines[0], PACK, lines[1]]) + "\n")
    got = post_training.load_teachers(str(manifest), "cpu")
    want = japp.load_teachers(str(manifest))
    assert_population_equal(got, want)


def test_params_json_roundtrip_matches_jax(tmp_path):
    jframes = jsample(jax.random.key(3), 1)
    one = jax.tree.map(lambda x: x[0], jframes)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jio.save_params_json(jpath, one)
    loaded = io.load_params_json(jpath, "cpu")
    assert loaded.mass.shape == (1,)
    for f in io._FIELDS:
        np.testing.assert_array_equal(getattr(loaded, f)[0].numpy(), np.asarray(getattr(one, f)))
    io.save_params_json(tpath, loaded)
    back = jio.load_params_json(tpath)
    for f in io._FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(one, f)))
    with pytest.raises(ValueError, match="one airframe per file"):
        io.save_params_json(tpath, dynamics_params_from_numpy(
            jax.tree.map(np.asarray, jsample(jax.random.key(3), 2)), "cpu"))
