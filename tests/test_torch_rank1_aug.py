"""The port's ``rank1_vn_celeb_aug`` (``ops.augment``) and its transform
(``data.transforms``) against the JAX package's on the CPU.

The JAX augmenters draw from a key inside the function; here each draw is
replayed along that augmenter's own split tree (for ``aug_add``, ``k1, k2,
k3 = jax.random.split(key, 3)``), the port's ``*_apply`` runs on those
parameters and the JAX augmenter on the key. Inputs are seeded numpy
images of 181 px (the repo's face crops) and 72 px, with saturated,
black and grey patches. Each test states its tolerance."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.data import transforms as JT
from vn_celeb_face_recognition_tpu.ops import augment as JA
from vn_celeb_face_recognition_tpu_torch.data import transforms as PT
from vn_celeb_face_recognition_tpu_torch.ops import augment as PA
from vn_celeb_face_recognition_tpu_torch.utils import kernels

NAMES = [name for name, _, _ in PA.RANK1_OPS]


def images(size, b=4, seed=0):
    """[b, size, size, 3] f32 integer values in [0, 255]: noise, a white
    and a black corner, a grey patch and a patch where r == g."""
    x = np.random.default_rng(seed + size).integers(
        0, 256, (b, size, size, 3)).astype(np.float32)
    x[:, :8, :8] = 255.0
    x[:, -8:, -8:] = 0.0
    x[:, :8, -8:] = x[:, :8, -8:, :1]
    x[:, -8:, :8, 1] = x[:, -8:, :8, 0]
    return x


# ---------------------------------------------------------------------------
# the JAX augmenters' split trees, replayed: key -> one image's parameters
# ---------------------------------------------------------------------------


def _u(key, lo, hi, shape=()):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _per_channel(key, lo, hi):
    k1, k2, k3 = jax.random.split(key, 3)
    return jnp.where(jax.random.bernoulli(k1, 0.5), _u(k2, lo, hi, (3,)),
                     _u(k3, lo, hi))


def _two(key, names, a, b):
    k1, k2 = jax.random.split(key)
    return {names[0]: _u(k1, *a), names[1]: _u(k2, *b)}


JAX_DRAWS = {
    "grayscale": lambda k: {"alpha": _u(k, 0.0, 1.0)},
    "hue_saturation": lambda k: _two(k, ("hue", "saturation"),
                                     (-20.0, 20.0), (-20.0, 20.0)),
    "add": lambda k: {"add": _per_channel(k, -20.0, 20.0)},
    "multiply": lambda k: {"mul": _per_channel(k, 0.5, 1.5)},
    "gaussian_blur": lambda k: {"sigma": _u(k, 0.0, 2.0)},
    "contrast": lambda k: {"alpha": _per_channel(k, 0.5, 2.0)},
    "sharpen": lambda k: _two(k, ("alpha", "lightness"), (0.0, 0.5),
                              (0.7, 1.3)),
    "emboss": lambda k: _two(k, ("alpha", "strength"), (0.0, 0.5),
                             (0.0, 1.5)),
}
JAX_OPS = dict(zip(NAMES, JA._RANK1_OPS))


@jax.jit
def _rank1_split(keys):
    """Per key, rank1_vn_celeb_aug's flip, apply and op, and every
    augmenter's parameters drawn from its k_op (vmapped)."""
    def one(key):
        k_flip, k_some, k_choice, k_op = jax.random.split(key, 4)
        return (jax.random.bernoulli(k_flip, 0.5),
                jax.random.bernoulli(k_some, 0.8),
                jax.random.randint(k_choice, (), 0, len(NAMES)),
                [JAX_DRAWS[n](k_op) for n in NAMES])
    return jax.vmap(one)(keys)


def replay_rank1(keys):
    """The port's rank1 parameters for one image per key, replayed from
    ``rank1_vn_celeb_aug``'s split of k_flip, k_some, k_choice, k_op."""
    flip, apply, op, ops = _rank1_split(keys)
    return {"flip": torch.tensor(np.asarray(flip)),
            "apply": torch.tensor(np.asarray(apply)),
            "op": torch.tensor(np.asarray(op), dtype=torch.int64),
            "ops": [{k: torch.tensor(np.asarray(v)) for k, v in d.items()}
                    for d in ops]}


@jax.jit
@jax.vmap
def jax_unwhitened(key, img):
    """JAX rank1_vn_celeb_aug up to its prewhiten: the flip and the chosen
    augmenter where apply is set, from the same split (vmapped)."""
    k_flip, k_some, k_choice, k_op = jax.random.split(key, 4)
    img = JA.aug_hflip(k_flip, img)
    op = jax.random.randint(k_choice, (), 0, len(NAMES))
    augmented = jax.lax.switch(
        op, [functools.partial(fn, k_op) for fn in JA._RANK1_OPS], img)
    return jnp.where(jax.random.bernoulli(k_some, 0.8), augmented, img)


def assert_rank1_close(got, x, keys, want=None):
    """The port's prewhitened batch against JAX's rank1_vn_celeb_aug on
    ``keys``: within 1e-5 of the exact (float64) prewhiten of JAX's
    flipped and augmented images, and within 5e-5 of JAX's own f32 output,
    whose mean over an image's 15,552 (72 px) or 98,283 (181 px) values
    is summed in f32 and errs by up to ~2e-5 relative."""
    x = jnp.asarray(x, jnp.float32)
    pre = np.asarray(jax_unwhitened(keys, x))
    if want is None:
        want = np.asarray(jax.jit(jax.vmap(JA.rank1_vn_celeb_aug))(keys, x))
    # the replayed split is JAX's pipeline (up to XLA's fusion order)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(JA.prewhiten)(jnp.asarray(pre))), want,
        rtol=0, atol=1e-6)
    pre = pre.astype(np.float64)
    mean = pre.mean(axis=(1, 2, 3), keepdims=True)
    std = pre.std(axis=(1, 2, 3), keepdims=True)
    exact = (pre - mean) / np.maximum(std, 1 / np.sqrt(pre[0].size))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


# ---------------------------------------------------------------------------
# the augmenters, one at a time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [181, 72])
@pytest.mark.parametrize("name", NAMES)
def test_augmenter_matches_jax_on_replayed_params(name, size):
    """Each augmenter's ``*_apply`` on parameters replayed from the JAX
    augmenter's key equals the JAX augmenter on that key within 1e-3 on
    the 0-255 scale (4 images, 4 keys)."""
    x = images(size)
    keys = jax.random.split(jax.random.PRNGKey(NAMES.index(name) + size), 4)
    want = np.asarray(jax.vmap(JAX_OPS[name])(keys, jnp.asarray(x)))
    params = {k: torch.tensor(np.asarray(v))
              for k, v in jax.vmap(JAX_DRAWS[name])(keys).items()}
    apply_fn = dict((n, fn) for n, _, fn in PA.RANK1_OPS)[name]
    got = apply_fn(torch.from_numpy(x), params).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_hsv_matches_jax_with_ties_and_round_trips():
    """rgb_to_hsv and hsv_to_rgb against JAX's within 1e-6 on pixels with
    r = g, g = b, r = b maxima and minima, grey, black and white pixels
    and random ones; hue 0 where the channels are equal; the round trip
    gives the pixel back within 1e-6."""
    ties = np.array([[1.0, 1.0, 0.2], [0.2, 0.7, 0.7], [0.6, 0.1, 0.6],
                     [0.3, 0.3, 0.9], [0.9, 0.4, 0.4], [0.5, 0.5, 0.5],
                     [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    rnd = np.random.default_rng(3).uniform(0, 1, (500, 3)).astype(np.float32)
    rgb = np.concatenate([ties, rnd])
    hsv = PA.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(),
                               np.asarray(JA.rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-6)
    assert torch.all(hsv[5:8, 0] == 0.0)
    back = PA.hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-6)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JA.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
        atol=1e-6)


def test_emboss_is_a_cross_correlation():
    """The emboss matrix is not symmetric: the port's emboss equals JAX's
    within 1e-3, and the same blend with the kernel flipped (a true
    convolution) misses it by more than 1 level."""
    x = images(72, b=2)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    want = np.asarray(jax.vmap(JA.aug_emboss)(keys, jnp.asarray(x)))
    p = {k: torch.tensor(np.asarray(v))
         for k, v in jax.vmap(JAX_DRAWS["emboss"])(keys).items()}
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(PA.emboss_apply(xt, p).numpy(), want,
                               atol=1e-3)
    flipped = PA.conv3x3_per_channel(
        xt, PA.emboss_kernels(p["strength"]).flip((-2, -1)))
    alpha = p["alpha"][:, None, None, None]
    wrong = torch.clamp((1 - alpha) * xt + alpha * flipped, 0, 255).numpy()
    assert np.abs(wrong - want).max() > 1.0


# ---------------------------------------------------------------------------
# the pipeline and the transform
# ---------------------------------------------------------------------------


def test_rank1_vn_celeb_aug_matches_jax_replayed():
    """rank1_vn_celeb_aug_apply on parameters replayed from 48 keys' splits
    (flips, skipped images and all eight augmenters among them) against
    JAX rank1_vn_celeb_aug on those keys, after prewhiten
    (``assert_rank1_close``)."""
    x = images(72, b=48, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(7), 48)
    params = replay_rank1(keys)
    applied = params["op"][params["apply"]].tolist()
    assert set(applied) == set(range(8))
    assert 0 < int(params["flip"].sum()) < 48
    assert not bool(params["apply"].all())
    got = PA.rank1_vn_celeb_aug_apply(torch.from_numpy(x), params).numpy()
    assert_rank1_close(got, x, keys)


def test_transform_rank1_aug_matches_jax():
    """The JAX transform on a uint8 batch and a key (one key an image, from
    jax.random.split(key, B)) against the port's apply on those replayed
    parameters (``assert_rank1_close``). The port's transform is
    rank1_vn_celeb_aug(gen, batch): equal on equal generators, another
    seed gives another batch; None raises; with_resize wraps it; no
    kernel launches on the CPU."""
    x = images(181, b=6, seed=9).astype(np.uint8)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(JT.transform_rank1_aug)(jnp.asarray(x), key))
    keys = jax.random.split(key, 6)
    params = replay_rank1(keys)
    got = PA.rank1_vn_celeb_aug_apply(torch.from_numpy(x), params).numpy()
    assert_rank1_close(got, x, keys, want)

    before = kernels.launch_counts()
    xt = torch.from_numpy(x)
    tf = PT.get_transform("rank1_aug")
    a = tf(xt, torch.Generator().manual_seed(1))
    b = PA.rank1_vn_celeb_aug(torch.Generator().manual_seed(1),
                              xt.to(torch.float32))
    assert a.dtype == torch.float32 and a.shape == xt.shape
    assert torch.equal(a, b)
    assert not torch.equal(a, tf(xt, torch.Generator().manual_seed(2)))
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="Generator"):
        tf(xt, None)
    resized = PT.with_resize(tf, 72)(xt, torch.Generator().manual_seed(1))
    assert resized.shape == (6, 72, 72, 3)
    # prewhitened: zero mean and unit std per image
    m = resized.mean(dim=(1, 2, 3))
    s = resized.std(dim=(1, 2, 3), correction=0)
    np.testing.assert_allclose(m.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# the port's draws
# ---------------------------------------------------------------------------

N_DRAWS = 4000
# each parameter's range, and whether it is one value a channel with
# probability 0.5 (else one for the image)
RANGES = {
    "grayscale": {"alpha": (0.0, 1.0, False)},
    "hue_saturation": {"hue": (-20.0, 20.0, False),
                       "saturation": (-20.0, 20.0, False)},
    "add": {"add": (-20.0, 20.0, True)},
    "multiply": {"mul": (0.5, 1.5, True)},
    "gaussian_blur": {"sigma": (0.0, 2.0, False)},
    "contrast": {"alpha": (0.5, 2.0, True)},
    "sharpen": {"alpha": (0.0, 0.5, False), "lightness": (0.7, 1.3, False)},
    "emboss": {"alpha": (0.0, 0.5, False), "strength": (0.0, 1.5, False)},
}


def share_ok(share, p, n=N_DRAWS):
    """Within 4 standard deviations of a Bernoulli(p) mean of n draws."""
    return abs(share - p) < 4 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("name", NAMES)
def test_rank1_draws(name):
    """4,000 draws: the op's share near 1/8 among all images; each of its
    parameters within its range, spread over it (mean at the middle within
    4 sigma of a uniform's), and one value a channel in near half of the
    images where the augmenter draws so; equal seeds draw equally."""
    p = PA.rank1_vn_celeb_aug_params(torch.Generator().manual_seed(3),
                                     N_DRAWS)
    k = NAMES.index(name)
    assert share_ok(float((p["op"] == k).float().mean()), 1 / 8)
    for field, (lo, hi, per_channel) in RANGES[name].items():
        v = p["ops"][k][field]
        assert v.shape == ((N_DRAWS, 3) if per_channel else (N_DRAWS,))
        assert float(v.min()) >= lo and float(v.max()) <= hi
        sd = (hi - lo) / np.sqrt(12 * v.numel())
        assert abs(float(v.mean()) - (lo + hi) / 2) < 4 * sd
        if per_channel:
            differ = (v[:, 0] != v[:, 1]) | (v[:, 1] != v[:, 2])
            assert share_ok(float(differ.float().mean()), 0.5)
    again = PA.rank1_vn_celeb_aug_params(torch.Generator().manual_seed(3),
                                         N_DRAWS)
    for field in RANGES[name]:
        assert torch.equal(again["ops"][k][field], p["ops"][k][field])


def test_rank1_flip_and_apply_draws():
    """flip ~ Bernoulli(0.5) and apply ~ Bernoulli(0.8) over 4,000 draws,
    op in {0..7}."""
    p = PA.rank1_vn_celeb_aug_params(torch.Generator().manual_seed(4),
                                     N_DRAWS)
    assert p["flip"].dtype == torch.bool and p["apply"].dtype == torch.bool
    assert share_ok(float(p["flip"].float().mean()), 0.5)
    assert share_ok(float(p["apply"].float().mean()), 0.8)
    assert set(p["op"].tolist()) == set(range(8))
