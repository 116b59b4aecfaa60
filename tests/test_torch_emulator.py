"""The torch port's emulator against the JAX package, on the CPU, from the
same numpy inputs: ``CosmoCNN`` through ``cnn_params_from_jax`` (the MC,
NLL and variational heads, both poolings), one train step's loss and
gradients, ``fit`` against ``_fit_host_loop`` (3 epochs, dropout 0, no
augmentation, the committed 16^3 fixture's data), ``evaluate_uq`` on a
heteroscedastic model, the MC-dropout sigma of ``evaluate_uq`` and the
dropout training objective on the same weights (against each other and
the exact sigma of the masks), ``create_linear_dataset`` fed the JAX
white noise, ``snapshots_to_delta`` on a port-written snapshot, the
12 x 8 cases of ``augment_batch`` and ``from_directory``'s val offset;
and the settled
differences (the ``.pt`` checkpoint, one fit loop, ``devices > 1``, the
per-volume generators).

Tolerances, float32 in both packages: outputs and gradients to 1e-5
(1e-4 for gradients) of their largest magnitude; the fit's losses to
1e-4 relative (Adam's first steps divide by |g|, which amplifies the
ulps of the smallest gradients) and its parameters to 1e-4 of each
tensor's largest magnitude."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.emulator import data as jdata
from nbody.emulator import model as jmodel
from nbody.emulator import train as jtrain
from nbody_torch.convert import cnn_params_from_jax
from nbody_torch.emulator import data as tdata
from nbody_torch.emulator import model as tmodel
from nbody_torch.emulator import train as ttrain
from nbody_torch.ic.gaussian import member_generator

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
FIXTURE = os.path.join(DATA, "emulator_n16_seed0.npz")
N = 16
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
FIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(model, dim=N, seed=0):
    """The JAX model's params for ``seed`` (jitted: flax's eager init of
    the variational model takes ~15 s on the CPU)."""
    k = jax.random.key(seed)
    init = jax.jit(lambda x: model.init({"params": k, "dropout": k,
                                         "sample": k}, x,
                                        deterministic=True)["params"])
    return _np_tree(init(jnp.zeros((1, dim, dim, dim), jnp.float32)))


def _port(jkw: dict, params, dim=N):
    m = tmodel.CosmoCNN(dim=dim, **jkw)
    m.load_state_dict(cnn_params_from_jax(params))
    return m


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def volumes():
    return np.random.default_rng(0).normal(size=(3, N, N, N)).astype(
        np.float32)


@pytest.fixture(scope="module")
def fixture():
    z = np.load(FIXTURE)
    params = {}
    for key in z.files:
        if key.startswith("param:"):
            layer, name = key[len("param:"):].split("/")
            params.setdefault(layer, {})[name] = z[key]
    tr = jdata.DeltaDataset(z["X_train"], z["y_train"], z["maxima"])
    va = jdata.DeltaDataset(z["X_val"], z["y_val"], z["maxima"])
    return z, params, tr, va


HEADS = {"mc": {}, "nll": dict(heteroscedastic=True, n_out=2),
         "var": dict(variational=True, dropout_rate=0.0)}


@pytest.mark.parametrize("global_pool", [True, False])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_forward_matches_jax(volumes, head, global_pool):
    kw = dict(n_conv=2, global_pool=global_pool, **HEADS[head])
    jm = jmodel.CosmoCNN(**kw)
    params = _jax_init(jm)
    x = volumes
    if head == "var":
        # rho at -30: sigma = softplus(-30) + 1e-6 ~ 1e-6, so the two
        # packages' different epsilon draws move the outputs by ~1e-6
        params = {layer: {k: (np.full_like(a, -30.0) if k.endswith("_rho")
                              else a) for k, a in group.items()}
                  for layer, group in params.items()}
        ref, _ = jax.jit(lambda p, v, k: jtrain._apply(
            jm, p, v, k, deterministic=True))(params, jnp.asarray(x),
                                              jax.random.key(1))
        m = _port(kw, params)
        got, kl = m(torch.as_tensor(x), torch.Generator().manual_seed(0))
        other, _ = m(torch.as_tensor(x), torch.Generator().manual_seed(1))
        # the JAX draw is one more draw: it may part from the port's by
        # three times what two of the port's draws part by
        spread = float((got - other).abs().max())
        assert 0.0 < spread < 1e-2 * float(got.abs().max())
        d = np.abs(got.detach().numpy() - np.asarray(ref)).max()
        assert d <= max(3 * spread, OUT_TOL * np.abs(np.asarray(ref)).max())
        # the KL terms: the JAX formula in float64 over the same weights
        kl64 = sum(float(jmodel._kl_std_normal(
            jnp.asarray(g[f"{w}_mu"], jnp.float64),
            jax.nn.softplus(jnp.asarray(g[f"{w}_rho"], jnp.float64)) + 1e-6))
            for g in params.values() for w in ("kernel", "bias"))
        assert float(kl.detach()) == pytest.approx(kl64, rel=1e-6)
        return
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params,
                                                           jnp.asarray(x))
    got, kl = _port(kw, params)(torch.as_tensor(x))
    assert got.shape == ref.shape and float(kl) == 0.0
    _close(got.detach(), ref, OUT_TOL)
    # the (B, N, N, N, 1) input is the same volume
    _close(_port(kw, params)(torch.as_tensor(x[..., None]))[0].detach(), ref,
           OUT_TOL)


@pytest.mark.parametrize("head", ["mc", "nll"])
def test_train_step_matches_jax(volumes, head):
    """One step's loss and gradients (dropout off: the packages' masks
    differ)."""
    kw = dict(n_conv=2, dropout_rate=0.0, **HEADS[head])
    jm = jmodel.CosmoCNN(**kw)
    params = _jax_init(jm)
    y = np.random.default_rng(1).uniform(0.9, 1.0, (3, kw.get("n_out", 1)))
    y = y.astype(np.float32)
    jloss = jmodel.gaussian_nll if head == "nll" else jmodel.mse_loss
    tloss = tmodel.gaussian_nll if head == "nll" else tmodel.mse_loss

    def loss(p):
        return jloss(jm.apply({"params": p}, jnp.asarray(volumes)),
                     jnp.asarray(y))

    ref_l, ref_g = jax.jit(jax.value_and_grad(loss))(params)
    m = _port(kw, params)
    pred, _ = m(torch.as_tensor(volumes))
    got_l = tloss(pred, torch.as_tensor(y))
    got_l.backward()
    assert float(got_l) == pytest.approx(float(ref_l), rel=OUT_TOL)
    ref_g = cnn_params_from_jax(_np_tree(ref_g))
    for name, p in m.named_parameters():
        _close(p.grad, ref_g[name], GRAD_TOL)


def test_fit_matches_jax_host_loop(fixture):
    """3 epochs of the committed fixture's data: the history, best epoch
    and best parameters against ``_fit_host_loop`` run here, which also
    reproduces the committed history the card is held to."""
    z, params, tr, va = fixture
    jm = jmodel.CosmoCNN(n_out=1, n_conv=2, dropout_rate=0.0)
    ref = jtrain._fit_host_loop(
        jm, tr, va, epochs=3, batch_size=4, lr=4e-3, seed=0, augment=False,
        kl_weight=None, early_stop_patience=None, early_stop_start=300,
        reduce_lr_patience=None, reduce_lr_factor=0.5, min_lr=1e-5,
        checkpoint_path=None, verbose=False, devices=1)
    for key in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(ref.history[key], z[key], rtol=1e-6)
    assert params.keys() == _jax_init(jm).keys()
    m = tmodel.CosmoCNN(n_out=1, n_conv=2, dropout_rate=0.0)
    res = ttrain.fit(m, tdata.DeltaDataset(tr.X, tr.y, tr.maxima),
                     tdata.DeltaDataset(va.X, va.y, va.maxima), epochs=3,
                     batch_size=4, lr=4e-3, seed=0, augment=False,
                     init_state=cnn_params_from_jax(params), device="cpu")
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(res.history[key], ref.history[key],
                                   rtol=FIT_TOL)
    assert res.history["lr"] == ref.history["lr"]
    assert res.best_epoch == ref.best_epoch
    assert res.best_val_loss == pytest.approx(ref.best_val_loss, rel=FIT_TOL)
    want = cnn_params_from_jax(_np_tree(ref.params))
    for name, p in res.params.items():
        _close(p, want[name], FIT_TOL)
        assert torch.equal(m.state_dict()[name], p)  # the best is loaded


def test_evaluate_uq_matches_jax(fixture):
    """A heteroscedastic model with dropout 0: every pass is the same, so
    mu, the aleatoric sigma, the coverage and the deviation follow from
    one forward in each package."""
    z, _, _, va = fixture
    kw = dict(n_out=1, n_conv=2, dropout_rate=0.0, heteroscedastic=True)
    jm = jmodel.CosmoCNN(**kw)
    params = _jax_init(jm, seed=3)
    ref = jtrain.evaluate_uq(jm, params, va, n_mc=4, seed=0, batch_size=4)
    got = ttrain.evaluate_uq(tmodel.CosmoCNN(dim=N, **kw),
                             cnn_params_from_jax(params),
                             tdata.DeltaDataset(va.X, va.y, va.maxima),
                             n_mc=4, seed=0, batch_size=4, device="cpu")
    np.testing.assert_allclose(got.mu, ref.mu, rtol=OUT_TOL)
    np.testing.assert_allclose(got.sigma_aleatoric, ref.sigma_aleatoric,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(got.y_true, ref.y_true, rtol=1e-7)
    assert got.sigma_epistemic.max() <= 1e-6 * np.abs(got.mu).max()
    # no truth lies near a sigma boundary, so the counts agree exactly
    margin = np.abs(np.abs(ref.y_true - ref.mu)[:, :, None]
                    / (ref.sigma_total[:, :, None] * np.arange(1, 4)) - 1)
    assert margin.min() > 1e-3
    np.testing.assert_array_equal(got.coverage, ref.coverage)
    np.testing.assert_allclose(got.abs_dev_percent, ref.abs_dev_percent,
                               rtol=1e-4)
    assert got.to_json().keys() == ref.to_json().keys()


MC_PASSES = 400


def _dropout_sigma(m, x):
    """The exact std of a dropout-0.2 model's output over its head-input
    masks: each of the 64 features h_j enters as W_j h_j m_j / keep with
    m_j ~ Bernoulli(keep), so var = (rate / keep) sum_j W_j^2 h_j^2."""
    feats = []
    hook = m.head.register_forward_hook(lambda mod, i, o: feats.append(i[0]))
    with torch.no_grad():
        det = m(torch.as_tensor(x))[0]
    hook.remove()
    w2 = m.head.weight.detach().double() ** 2
    rate = m.dropout_rate
    var = rate / (1 - rate) * (feats[0].double() ** 2) @ w2.T
    return det.double().numpy(), var.sqrt().numpy()


@pytest.mark.parametrize("full_dropout", [False, True])
def test_mc_dropout_sigma_matches_jax(fixture, full_dropout):
    """``evaluate_uq`` with dropout 0.2 on the same converted weights:
    the epistemic sigma of each volume over 400 passes against the JAX
    package's.  With dropout on the head input only, both are held to
    the exact sigma of that mask distribution, and the MC mean to the
    deterministic output: a std from n passes has a relative standard
    error of about 1 / sqrt(2n) = 3.5% (kurtosis of the Bernoulli sum
    near 3), so 20% is 5.7 of them.  With dropout after every conv block
    there is no closed form, and the two packages' estimates are held to
    each other: two such estimates part with a standard error of 5%, so
    25% is 5 of them."""
    z, _, _, va = fixture
    kw = dict(n_out=1, n_conv=2, dropout_rate=0.2, full_dropout=full_dropout)
    jm = jmodel.CosmoCNN(**kw)
    params = _jax_init(jm, seed=5)
    sub = jdata.DeltaDataset(va.X[:2], va.y[:2], va.maxima)
    ref = jtrain.evaluate_uq(jm, params, sub, n_mc=MC_PASSES, seed=0,
                             batch_size=2)
    m = _port(kw, params)
    got = ttrain.evaluate_uq(m, None, tdata.DeltaDataset(sub.X, sub.y,
                                                         sub.maxima),
                             n_mc=MC_PASSES, seed=0, batch_size=2,
                             device="cpu")
    scale = float(sub.maxima[0])
    epi_got = got.sigma_epistemic[:, 0] / scale
    epi_ref = ref.sigma_epistemic[:, 0] / scale
    assert epi_got.min() > 0 and epi_ref.min() > 0
    if full_dropout:
        np.testing.assert_allclose(epi_got, epi_ref, rtol=0.25)
        return
    det, exact = _dropout_sigma(m, sub.X)
    np.testing.assert_allclose(epi_got, exact[:, 0], rtol=0.20)
    np.testing.assert_allclose(epi_ref, exact[:, 0], rtol=0.20)
    for ev in (got, ref):
        assert np.all(np.abs(ev.mu[:, 0] / scale - det[:, 0])
                      <= 5 * exact[:, 0] / np.sqrt(MC_PASSES))


def test_dropout_training_objective_matches_jax(volumes):
    """The training loss with dropout 0.2 on, and its gradient, averaged
    over masks: each volume repeated 128 times in one batch (every row
    draws its own mask in both packages), so one loss is the mean over
    128 x 3 masks.  The mean loss is held to its exact value, the squared
    deterministic error plus the dropout variance of
    ``_dropout_sigma``; the mean gradients of the two packages to each
    other, within three times what two of the port's own mask sets part
    by.  That spread is well below how far dropout moves the head
    kernel's mean gradient (by 2 (rate / keep) W_j h_j^2) from its
    deterministic value."""
    kw = dict(n_out=1, n_conv=2, dropout_rate=0.2)
    jm = jmodel.CosmoCNN(**kw)
    params = _jax_init(jm, seed=6)
    m = _port(kw, params)
    det, exact = _dropout_sigma(m, volumes)
    y = (det + 0.5 * exact).astype(np.float32)  # the variance term matters
    reps = 128
    x = np.repeat(volumes, reps, axis=0)
    yr = np.repeat(y, reps, axis=0)

    def jloss(p):
        pred, _ = jtrain._apply(jm, p, jnp.asarray(x), jax.random.key(2),
                                deterministic=False)
        return jmodel.mse_loss(pred, jnp.asarray(yr))

    ref_l, ref_g = jax.jit(jax.value_and_grad(jloss))(params)
    ref_g = cnn_params_from_jax(_np_tree(ref_g))

    def port(seed, dropout=True):
        m.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(seed) if dropout else None
        loss = tmodel.mse_loss(m(torch.as_tensor(x), gen)[0],
                               torch.as_tensor(yr))
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in
                             m.named_parameters()}

    (l0, g0), (_, g1), (_, gdet) = port(0), port(1), port(0, False)
    want = float(np.mean((det - y) ** 2 + exact**2))
    se = want * np.sqrt(2.0 / (3 * reps))  # a mean of 3 x 128 chi-squares
    for loss in (l0, float(ref_l)):
        assert abs(loss - want) <= 5 * se
    def spread(a, b, name):
        return float((a[name] - b[name]).abs().max())

    assert spread(g0, g1, "head.weight") < 0.5 * spread(g0, gdet,
                                                          "head.weight")
    for name in g0:
        assert spread(g0, ref_g, name) <= 3 * spread(g0, g1, name), name


def _jax_noise(master_seed, n, nmesh):
    """The unit white noise JAX's create_linear_dataset draws for each
    sample (``_realize_batch``: split(key), the field from the first)."""
    keys = jax.random.split(jax.random.key(master_seed), n)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.split(k)[0], (nmesh,) * 3, jnp.float32)) for k in keys])


@pytest.mark.parametrize("vary", ["amplitude", "shape"])
def test_create_linear_dataset_matches_jax(tmp_path, vary):
    """The amplitude branch (a batch of volumes at once) on a train/val
    split, the shape branch (n_s varies: one volume at a time) on a test
    split of one volume (each JAX compile costs seconds)."""
    n, nmesh = (4, 8) if vary == "amplitude" else (1, 8)
    kw = dict(z=0.5, box=200.0, nmesh=nmesh, A_s_min=1.5e-9,
              A_s_max=2.7e-9, val_size=0.5, batch=4)
    if vary == "shape":
        kw.update(n_s_min=0.9, n_s_max=1.0, test=True)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jdata.create_linear_dataset(jroot, n, **kw)
    got = tdata.create_linear_dataset(troot, n, noise=_jax_noise(0, n, nmesh),
                                      device="cpu", **kw)
    np.testing.assert_array_equal(got, ref)
    tables = (("TestParams.txt",) if vary == "shape"
              else ("TrainingParams.txt", "ValParams.txt"))
    for name in ("BoxParams.txt", "MaxMinParams.txt") + tables:
        with open(os.path.join(jroot, name), "rb") as a, \
                open(os.path.join(troot, name), "rb") as b:
            assert a.read() == b.read(), name
    for i in range(1, n + 1):
        r = np.load(tdata.delta_path(jroot, i, vary == "shape"))
        g = np.load(tdata.delta_path(troot, i, vary == "shape"))
        assert g.dtype == np.float32 and g.shape == (nmesh,) * 3
        _close(g, r, OUT_TOL)


def test_volume_draws_are_their_own(tmp_path):
    """Philox, not threefry: a volume's field comes from its own
    generator (master_seed, i), so the batch it is drawn in, a resume and
    the test split's noise do not change it; the noise_frac draw follows
    the field from the same generator."""
    kw = dict(z=0.0, box=200.0, nmesh=8, A_s_min=1.5e-9, A_s_max=2.7e-9,
              device="cpu")
    tdata.create_linear_dataset(str(tmp_path / "a"), 5, batch=5, **kw)
    tdata.create_linear_dataset(str(tmp_path / "b"), 5, batch=2, **kw)
    p = tdata.delta_path(str(tmp_path / "b"), 3)
    os.remove(p)
    tdata.create_linear_dataset(str(tmp_path / "b"), 5, batch=2, **kw)
    for i in range(1, 6):
        assert np.array_equal(np.load(tdata.delta_path(str(tmp_path / "a"), i)),
                              np.load(tdata.delta_path(str(tmp_path / "b"), i)))
    g = member_generator(0, 2)
    w = torch.randn((8,) * 3, generator=g, dtype=torch.float64)
    assert not torch.equal(w, torch.randn((8,) * 3,
                                          generator=member_generator(0, 3),
                                          dtype=torch.float64))
    tdata.create_linear_dataset(str(tmp_path / "c"), 5, noise_frac=0.1, **kw)
    a = np.load(tdata.delta_path(str(tmp_path / "a"), 2))
    c = np.load(tdata.delta_path(str(tmp_path / "c"), 2))
    g = member_generator(0, 1)
    torch.randn((8,) * 3, generator=g, dtype=torch.float64)  # the field
    extra = torch.randn((8,) * 3, generator=g, dtype=torch.float64).numpy()
    _close(c - a, 0.1 * a.max() * extra, OUT_TOL)


def test_snapshots_to_delta_matches_jax(tmp_path):
    """A port-written snapshot through both packages' ETL, and
    ``state_to_delta`` on a batch of states equal to each state's."""
    from nbody.emulator.data import snapshots_to_delta as j_etl
    from nbody_torch.core.types import ParticleState
    from nbody_torch.io.snapshot import SnapshotMeta, write_snapshot

    rng = np.random.default_rng(4)
    box, nmesh = 100.0, 8
    pos = rng.uniform(0, box, (2, 600, 3))
    ens = tmp_path / "ens"
    for b in range(2):
        st = ParticleState.create(pos[b], np.zeros_like(pos[b]),
                                  np.ones(600), 1.0, device="cpu",
                                  dtype=torch.float32)
        write_snapshot(str(ens / f"id{b:04d}_A_s2.0e-09" / "snapshots"
                           / "snapshot_a=1.00.hdf5"), st,
                       SnapshotMeta(a=1.0, boxsize=box))
    ref = j_etl(str(ens), str(tmp_path / "jax"), nmesh)
    got = tdata.snapshots_to_delta(str(ens), str(tmp_path / "port"), nmesh,
                                   device="cpu")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in ref]
    for g, r in zip(got, ref):
        a, b = np.load(g), np.load(r)
        assert a.shape == (nmesh, nmesh, nmesh, 1) and a.dtype == np.float32
        _close(a, b, OUT_TOL)
    p32 = torch.as_tensor(pos, dtype=torch.float32)
    both = tdata.state_to_delta(p32, box, nmesh)
    for b in range(2):
        assert torch.equal(both[b], tdata.state_to_delta(p32[b], box, nmesh))
    _close(both[0].numpy(), np.load(ref[0])[..., 0], OUT_TOL)


@pytest.mark.parametrize("case", range(12))
def test_augment_cases_match_jax(case):
    """Rot90 case ``case`` under each of the 8 flip patterns, one gather
    for the batch, against the JAX package's per-sample transform."""
    n = 4
    rng = np.random.default_rng(case)
    X = rng.normal(size=(8, n, n, n, 2)).astype(np.float32)
    flips = np.array([[(f >> 2) & 1, (f >> 1) & 1, f & 1] for f in range(8)],
                     dtype=bool)
    got = tdata.augment_cases(torch.as_tensor(X), torch.as_tensor(flips),
                              torch.full((8,), case))
    rot = jdata._rot_case(case)
    for b in range(8):
        v = jnp.asarray(X[b])
        for ax in range(3):
            if flips[b, ax]:
                v = jnp.flip(v, ax)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(rot(v)))
    squeezed = tdata.augment_cases(torch.as_tensor(X[..., 0]),
                                   torch.as_tensor(flips),
                                   torch.full((8,), case))
    assert torch.equal(squeezed, got[..., 0])


def test_augment_batch_draws():
    X = torch.randn(64, 4, 4, 4)
    a = tdata.augment_batch(X, torch.Generator().manual_seed(5))
    b = tdata.augment_batch(X, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, X)
    # every output is a permutation of its volume
    assert torch.equal(a.reshape(64, -1).sort(dim=1).values,
                       X.reshape(64, -1).sort(dim=1).values)


def test_from_directory_matches_jax(tmp_path):
    """The val split's ids continue after the train ids; the test labels
    stay 3-wide; the port's native loader reads what JAX's reads."""
    root = str(tmp_path / "d")
    kw = dict(z=0.0, box=200.0, nmesh=8, A_s_min=1.5e-9, A_s_max=2.7e-9)
    tdata.create_linear_dataset(root, 8, val_size=0.25, device="cpu", **kw)
    tdata.create_linear_dataset(root, 3, test=True, device="cpu", **kw)
    for split in ("train", "val", "test"):
        ref = jdata.DeltaDataset.from_directory(root, split)
        got = tdata.DeltaDataset.from_directory(root, split)
        np.testing.assert_array_equal(got.X, ref.X)
        np.testing.assert_array_equal(got.y, ref.y)
        np.testing.assert_array_equal(got.maxima, ref.maxima)
        assert got.vary_flags == ref.vary_flags
    val = tdata.DeltaDataset.from_directory(root, "val")
    assert len(val) == 2 and np.array_equal(
        val.X[0], np.load(tdata.delta_path(root, 7)))
    assert tdata.DeltaDataset.from_directory(root, "test").y.shape == (3, 3)
    batches = list(val.batches(4, shuffle=False, drop_remainder=False,
                               device="cpu"))
    assert len(batches) == 1 and batches[0][0].shape == (2, 8, 8, 8)


def test_checkpoint_is_a_state_dict(tmp_path, fixture):
    """Settled: a ``.pt`` state_dict where the JAX package writes msgpack;
    fit's one loop (no ``epoch_chunk`` / ``host_loop``); devices > 1
    raises."""
    _, params, tr, va = fixture
    m = tmodel.CosmoCNN(dropout_rate=0.0)
    ds_tr = tdata.DeltaDataset(tr.X, tr.y, tr.maxima)
    ds_va = tdata.DeltaDataset(va.X, va.y, va.maxima)
    path = str(tmp_path / "ck" / "params.pt")
    res = ttrain.fit(m, ds_tr, ds_va, epochs=1, batch_size=8, seed=1,
                     checkpoint_path=path, device="cpu")
    loaded = ttrain.load_params(path, tmodel.CosmoCNN())
    assert loaded.keys() == res.params.keys()
    assert all(torch.equal(loaded[k], res.params[k]) for k in loaded)
    sig = inspect.signature(ttrain.fit).parameters
    assert "epoch_chunk" not in sig and "host_loop" not in sig
    with pytest.raises(ValueError, match="torch.distributed"):
        ttrain.fit(m, ds_tr, ds_va, epochs=1, devices=2, device="cpu")
    # a fit from its seed repeats its bits, augmentation and dropout on
    again = ttrain.fit(tmodel.CosmoCNN(dropout_rate=0.0), ds_tr, ds_va,
                       epochs=1, batch_size=8, seed=1, device="cpu")
    assert again.history == res.history


def test_model_checks():
    assert [tmodel.max_conv_blocks(n) for n in (8, 16, 32)] == [1, 2, 3]
    with pytest.raises(ValueError, match="collapses"):
        tmodel.CosmoCNN(n_conv=2)(torch.zeros(1, 8, 8, 8))
    with pytest.raises(ValueError, match="dim"):
        tmodel.CosmoCNN(global_pool=False)
    with pytest.raises(ValueError, match="generator"):
        tmodel.CosmoCNN(variational=True)(torch.zeros(1, 16, 16, 16))
    a = tmodel.CosmoCNN().state_dict()
    b = tmodel.CosmoCNN().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # flax's lecun_normal: truncated at 2 sigma, variance 1 / fan_in
    w = tmodel.CosmoCNN(filters=64).convs[1].weight
    assert float(w.abs().max()) <= 2 * (1 / (27 * 64)) ** 0.5 / \
        tmodel.TRUNC_STD + 1e-7
    assert float(w.std()) == pytest.approx((1 / (27 * 64)) ** 0.5, rel=0.02)
    bf = tmodel.CosmoCNN(compute_dtype="bf16")(torch.randn(2, 16, 16, 16))[0]
    assert bf.dtype == torch.float32
