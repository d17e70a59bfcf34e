"""The port's whole hsiMamba surface against the JAX package, on the CPU.

Modelled on tests/test_path_types.py: every path type of the layer (the
shuffle streams, the per-sample gate, the static orderings), the single
``MambaMixer``, and the backbone's cls positions, output types, position
embeddings, 'multi_clock_gate' and dropout. Seeded random values for every
parameter go into the flax module and, through vit_cnn_tpu_torch.convert,
into the port; the same numpy inputs go through both. JAX's shuffle
permutations are handed to the port: the key each mixer draws is caught
with ``flax.linen.intercept_methods`` (the layer's ``_shuffle_key``),
``jax.random.permutation(key, L)`` is what the layer permutes by, and the
port replays it through ``noise.Replay``. Dropout masks are drawn here
and given to both.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5
(tests/test_torch_mm_mamba.py): both sides are float32 but sum in other
orders. The float64 train steps against ``jax.grad``: 1e-7 relative per
tensor in norm, plus 1e-12 of the largest gradient norm.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.nn import mamba as jax_mamba
from vit_cnn_tpu_torch.convert import (flax_to_state_dict, seeded_state_dict,
                                       seeded_variables, state_dict_to_flax)
from vit_cnn_tpu_torch.nn import MambaMixer, noise
from vit_cnn_tpu_torch.nn.mamba import (DirectionalMambaBackbone,
                                        MultiDirMambaLayer,
                                        sincos_2d_position_embedding)
from vit_cnn_tpu_torch.ops.scan_paths import (inverse_permutation,
                                              path_orderings, path_spec)

RTOL, ATOL = 2e-4, 2e-5
TOL64, FLOOR64 = 1e-7, 1e-12
HIDDEN, INTER = 16, 8

ALL_LAYER_PATHS = [
    ("forward", 49), ("shuffle", 49), ("eight_directions_gate", 49),
    ("9twoclock", 9), ("25twoclock", 25), ("49twoclock", 49),
    ("81twoclock", 81), ("49_2+8", 49), ("81_2+8", 81),
    ("forward_reverse_mean", 49), ("forward_reverse_gate", 49),
    ("forward_reverse_shuffle_gate", 49),
    ("forward_reverse_shuffle_mean", 49),
]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def _tree(module, *args, seed=1, **kw):
    key = jax.random.PRNGKey(0)
    init = jax.eval_shape(lambda: module.init(
        {"params": key, "shuffle": key, "dropout": key}, *args, **kw))
    return flax.core.unfreeze(init), seeded_variables(
        flax.core.unfreeze(init), seed)


def _load(model, tree):
    model.load_state_dict(flax_to_state_dict(tree, model))
    return model


class _Draws:
    """JAX's side of the shared draws: each mixer's shuffle key is caught
    (and its permutation kept, as the port's replay draws), each dropout
    takes the next given uniform (u < 1 - rate keeps, as the port)."""

    def __init__(self, L, uniforms=()):
        self.L = L
        self.uniforms = list(uniforms)
        self.replay = []

    def interceptor(self, next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "_shuffle_key":
            key = next_fun(*args, **kwargs)
            perm = np.array(jax.random.permutation(key, self.L))
            self.replay.append(torch.from_numpy(perm))
            return key
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            x = args[0]
            if mod.deterministic or mod.rate == 0.0:
                return x
            u = self.uniforms.pop(0)
            self.replay.append(u)
            keep = jnp.asarray((u < 1.0 - mod.rate).numpy())
            return jax.lax.select(keep, x / (1.0 - mod.rate),
                                  jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def apply(self, fn):
        with fnn.intercept_methods(self.interceptor):
            return fn()


def _jax_layer(path_type):
    return jax_mamba.MultiDirMambaLayer(HIDDEN, INTER, path_type=path_type,
                                        use_pallas=False)


def _layer_case(path_type, L, b=3, seed=0):
    x = np.random.RandomState(seed).randn(b, L, HIDDEN).astype(np.float32)
    jl = _jax_layer(path_type)
    _, tree = _tree(jl, x)
    return x, jl, tree


# --------------------------------------------------------------------------
# the layer, every path type
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path_type,L", ALL_LAYER_PATHS)
def test_layer_matches_jax(path_type, L):
    x, jl, tree = _layer_case(path_type, L)
    draws = _Draws(L)
    key = jax.random.PRNGKey(5)
    want = np.asarray(draws.apply(
        lambda: jl.apply(tree, x, rngs={"shuffle": key})))
    assert len(draws.replay) == path_spec(path_type).n_shuffle
    tl = _load(MultiDirMambaLayer(HIDDEN, INTER, path_type, L), tree)
    assert _paths(state_dict_to_flax(tl)) == _paths(tree)
    rep = noise.Replay(draws.replay)
    with torch.no_grad(), noise.drawing(rep):
        got = tl(torch.from_numpy(x)).numpy()
    assert rep.taken == len(draws.replay)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _port_streams(layer, x, perms):
    """The reference's widened-batch formulation on the port's own
    parameters: gather every ordering, one shared MambaMixer, inverse
    gathers; the restored streams."""
    mixer = MambaMixer(HIDDEN, INTER)
    mixer.load_state_dict({k: v for k, v in layer.state_dict().items()
                           if not k.startswith(("direction_gate", "gate"))})
    streams = []
    for p in perms:
        p = np.asarray(p)
        mixed = mixer(x[:, torch.from_numpy(p)])
        streams.append(mixed[:, torch.from_numpy(inverse_permutation(p))])
    return streams


@pytest.mark.parametrize("path_type,L", ALL_LAYER_PATHS)
def test_matches_literal_formulation(path_type, L):
    """The port's layer == the literal widened-batch formulation with the
    exact per-path gate semantics of the reference branch, on the port's
    own parameters and the permutation its layer drew."""
    layer = MultiDirMambaLayer(HIDDEN, INTER, path_type, L)
    layer.load_state_dict(seeded_state_dict(layer, 4))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, L, HIDDEN).astype(np.float32))
    rec = noise.Recorder(torch.Generator().manual_seed(6))
    with torch.no_grad():
        with noise.drawing(rec):
            got = layer(x)
        spec = path_spec(path_type)
        assert len(rec.draws) == spec.n_shuffle
        perms = list(path_orderings(path_type, L)) + rec.draws
        streams = _port_streams(layer, x, perms)
        n_dir = len(streams)
        if spec.combine == "softmax10":
            w = torch.softmax(layer.direction_gate, 0)[:n_dir]
            want = sum(w[i] * streams[i] for i in range(n_dir))
        elif spec.combine == "raw10":
            w = layer.direction_gate[:n_dir]
            want = sum(w[i] * streams[i] for i in range(n_dir))
        elif spec.combine == "mean":
            want = sum(streams) / n_dir
        elif spec.combine == "dynamic":
            gate_in = torch.cat([s.mean(dim=1) for s in streams], dim=-1)
            dyn = torch.softmax(layer.gate(gate_in), -1)
            want = sum(dyn[:, i, None, None] * streams[i]
                       for i in range(n_dir))
        else:                                               # none
            want = sum(streams)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                               atol=5e-5)


def test_shuffle_draws_a_fresh_permutation_every_call():
    """A new permutation each call under a generator (train and eval, as
    upstream's torch.randperm); outside noise.drawing the fixed fallback
    seed, the same permutation every call."""
    layer = MultiDirMambaLayer(HIDDEN, INTER, "shuffle", 49)
    layer.load_state_dict(seeded_state_dict(layer, 2))
    x = torch.randn(2, 49, HIDDEN, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        rec = noise.Recorder(torch.Generator().manual_seed(0))
        with noise.drawing(rec):
            o1, o2 = layer(x), layer(x)
        assert len(rec.draws) == 2
        assert not torch.equal(rec.draws[0], rec.draws[1])
        assert not torch.allclose(o1, o2)
        with noise.drawing(noise.Replay(rec.draws[:1])):
            np.testing.assert_array_equal(layer(x).numpy(), o1.numpy())
        f1, f2 = layer(x), layer(x)
    np.testing.assert_array_equal(f1.numpy(), f2.numpy())
    fixed = torch.randperm(49, generator=torch.Generator().manual_seed(
        noise.FALLBACK_SEED))
    with torch.no_grad(), noise.drawing(noise.Replay([fixed])):
        np.testing.assert_array_equal(layer(x).numpy(), f1.numpy())


def test_replay_refuses_a_draw_of_another_kind():
    rep = noise.Replay([torch.arange(5)])
    with pytest.raises(RuntimeError, match="permutation"):
        with noise.drawing(rep):
            noise.uniform((5,), "cpu")
    rep = noise.Replay([torch.rand(5)])
    with pytest.raises(RuntimeError, match="uniform"):
        with noise.drawing(rep):
            noise.permutation(5, "cpu")
    rep = noise.Replay([torch.arange(4)])
    with pytest.raises(RuntimeError, match="shape"):
        with noise.drawing(rep):
            noise.permutation(5, "cpu")


def test_direction_slots_follow_jax():
    """Static directions first, then the shuffle stream at n_static + k;
    'forward_reverse_shuffle_gate' softmaxes 10 slots and uses 3."""
    fr = MultiDirMambaLayer(HIDDEN, INTER, "forward_reverse_shuffle_gate", 9)
    assert fr.n_dir == 3 and fr.direction_gate.shape == (10,)
    assert fr.fwd_dir.tolist() == [0, 2] and fr.rev_dir.tolist() == [1]
    assert fr.orders.shape == (1, 9) and fr.rev_rows.tolist() == [0]
    sh = MultiDirMambaLayer(HIDDEN, INTER, "shuffle", 9)
    assert sh.n_dir == 1 and sh.orders.shape == (0, 9)
    assert sh.fwd_dir.tolist() == [0] and not hasattr(sh, "direction_gate")
    gate = MultiDirMambaLayer(HIDDEN, INTER, "forward_reverse_gate", 9)
    assert gate.gate.weight.shape == (2, 2 * HIDDEN)


def test_layer_refuses_what_jax_refuses():
    """A grid path over a token count that is not a square (cls tokens)
    and 'multi_clock_gate' (no layer) raise as the JAX layer does."""
    x = np.zeros((1, 50, HIDDEN), np.float32)
    with pytest.raises(AssertionError):
        _jax_layer("eight_directions_gate").init(jax.random.PRNGKey(0), x)
    with pytest.raises(AssertionError):
        MultiDirMambaLayer(HIDDEN, INTER, "eight_directions_gate", 50)
    x = np.zeros((1, 49, HIDDEN), np.float32)
    with pytest.raises(ValueError):
        _jax_layer("multi_clock_gate").init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        MultiDirMambaLayer(HIDDEN, INTER, "multi_clock_gate", 49)


# --------------------------------------------------------------------------
# MambaMixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,L", [(3, 9), (2, 81), (1, 1)])
def test_mixer_matches_jax(b, L):
    x = np.random.RandomState(L).randn(b, L, HIDDEN).astype(np.float32)
    jm = jax_mamba.MambaMixer(HIDDEN, INTER, use_pallas=False)
    _, tree = _tree(jm, x, seed=L)
    want = np.asarray(jm.apply(tree, x))
    tm = _load(MambaMixer(HIDDEN, INTER), tree)
    assert _paths(state_dict_to_flax(tm)) == _paths(tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mixer_is_exported_as_in_jax():
    import vit_cnn_tpu.nn as jnn

    import vit_cnn_tpu_torch.nn as tnn
    assert tnn.MambaMixer is MambaMixer
    assert hasattr(jnn, "MambaMixer")


# --------------------------------------------------------------------------
# the backbone
# --------------------------------------------------------------------------

# (path_type, img, pe_type, cls_position, out_type, drop_rate)
BACKBONES = [
    ("forward_reverse_shuffle_gate", 5, "learnable", "head", "cls_token", 0),
    ("forward", 5, "learnable", "tail", "cls_token", 0),
    ("forward_reverse_gate", 5, "learnable", "head_tail", "cls_token", 0),
    ("shuffle", 5, "learnable", "middle", "cls_token", 0),
    ("forward_reverse_mean", 5, "learnable", "middle", "featmap", 0),
    ("forward_reverse_shuffle_mean", 5, "learnable", "head_tail",
     "avg_featmap", 0),
    ("forward", 5, "none", "tail", "raw", 0),
    ("49_2+8", 7, "sine", "none", "featmap", 0),
    ("9twoclock", 3, "none", "none", "avg_featmap", 0),
    ("multi_clock_gate", 5, "learnable", "none", "raw", 0),
    ("forward_reverse_shuffle_gate", 5, "sine", "none", "featmap", 0.1),
    ("eight_directions_gate", 5, "learnable", "none", "featmap", 0.1),
]


def _backbone_case(path_type, img, pe_type, cls_position, out_type,
                   drop_rate, layers=2, ch=4, b=3):
    kw = dict(path_type=path_type, pe_type=pe_type,
              cls_position=cls_position, out_type=out_type)
    jb = jax_mamba.DirectionalMambaBackbone(
        embed_dims=HIDDEN, num_layers=layers, feedforward_channels=INTER,
        img_size=img, in_channels=ch, drop_rate=drop_rate, use_pallas=False,
        **kw)
    tb = DirectionalMambaBackbone(HIDDEN, layers, INTER, img, ch,
                                  drop_rate=drop_rate, **kw)
    x = np.random.RandomState(img).randn(b, img, img, ch).astype(np.float32)
    return jb, tb, x


@pytest.mark.parametrize("case", BACKBONES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_backbone_matches_jax(case):
    jb, tb, x = _backbone_case(*case)
    path_type, img, pe_type, cls_position, out_type, drop_rate = case
    init, tree = _tree(jb, x, train=False)
    _load(tb, tree)
    assert _paths(state_dict_to_flax(tb)) == _paths(init)
    L = img * img + tb.n_extra
    train = drop_rate > 0
    uniforms = [torch.rand((x.shape[0], L, HIDDEN),
                           generator=torch.Generator().manual_seed(9))] \
        if train else []
    draws = _Draws(L, uniforms)
    key = jax.random.PRNGKey(11)
    want = np.asarray(draws.apply(lambda: jb.apply(
        tree, x, train=train, rngs={"shuffle": key, "dropout": key})))
    tb.train(train)
    rep = noise.Replay(draws.replay)
    with torch.no_grad(), noise.drawing(rep):
        got = tb(torch.from_numpy(x)).numpy()
    assert rep.taken == len(draws.replay)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_backbone_refuses_what_jax_refuses():
    """Sine with cls tokens, a grid path with cls tokens, cls_token output
    without a cls position: the errors the JAX backbone raises."""
    x = np.zeros((1, 5, 5, 4), np.float32)
    for kw, err in [(dict(pe_type="sine", cls_position="head",
                          path_type="forward"), AssertionError),
                    (dict(cls_position="head", path_type="25_2+8"),
                     AssertionError),
                    (dict(out_type="cls_token", path_type="forward"),
                     ValueError)]:
        jb = jax_mamba.DirectionalMambaBackbone(
            embed_dims=HIDDEN, num_layers=1, feedforward_channels=INTER,
            img_size=5, in_channels=4, use_pallas=False, **kw)
        with pytest.raises(err):
            jax.eval_shape(jb.init, jax.random.PRNGKey(0), x)
        with pytest.raises(err):
            DirectionalMambaBackbone(HIDDEN, 1, INTER, 5, 4, **kw)


def test_convert_round_trip_of_the_new_leaves():
    """The per-sample ``gate``, ``cls_token`` and ``ln2`` go both ways
    strictly: a round trip is exact, a stray or missing leaf raises."""
    tb = DirectionalMambaBackbone(HIDDEN, 1, INTER, 5, 4,
                                  path_type="forward_reverse_gate",
                                  cls_position="head_tail",
                                  out_type="avg_featmap")
    tb.load_state_dict(seeded_state_dict(tb, 5))
    tree = state_dict_to_flax(tb)
    p = tree["params"]
    assert p["mixer0"]["gate"]["kernel"].shape == (2 * HIDDEN, 2)
    assert p["cls_token"].shape == (1, 2, HIDDEN)
    assert set(p["ln2"]) == {"scale", "bias"}
    back = flax_to_state_dict(tree, tb)
    for k, t in tb.state_dict().items():
        assert torch.equal(back[k], t), k
    p["mixer0"]["gate"]["bias"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="gate"):
        flax_to_state_dict(tree, tb)
    del p["mixer0"]["gate"]
    with pytest.raises(KeyError, match="left unset"):
        flax_to_state_dict(tree, tb)


def test_sine_embedding_equals_jax():
    for h, w, e in [(5, 7, 16), (9, 9, 144), (1, 3, 4)]:
        np.testing.assert_array_equal(
            sincos_2d_position_embedding(h, w, e),
            jax_mamba.sincos_2d_position_embedding(h, w, e))


def test_bf16_sine_backbone_matches_jax_bf16():
    """A two-layer sine backbone in bf16 against the JAX backbone in bf16
    (its parameters cast to bf16, as ``cast_floating`` does, and bf16
    input), from the same converted weights, at the bf16 limit (2e-2,
    2e-2). JAX adds the sine table as a float32 constant, which promotes
    its tokens and every later layer to float32 (from the bf16
    parameters); the port adds the table in the tokens' dtype and stays
    in bf16. The two agree within the limit: max|diff| 0.021 against a
    largest |output| of 3.34 (the worst entry at 0.79 of its allowance),
    so the port keeps its bf16 path."""
    jb, tb, x = _backbone_case("49_2+8", 7, "sine", "none", "featmap", 0)
    _, tree = _tree(jb, x, train=False)
    _load(tb, tree)
    as_bf16 = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), t)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jb.apply(as_bf16(tree), xb, train=False), np.float32)
    tb.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = tb(torch.tensor(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_backbone_init_matches_flax_init_rules():
    """reset_parameters: cls tokens zeros (flax zeros init), the gate
    parameters as the JAX layer initialises them."""
    from vit_cnn_tpu_torch.nn.layers import init_parameters

    tb = init_parameters(DirectionalMambaBackbone(
        HIDDEN, 1, INTER, 5, 4, path_type="forward_reverse_shuffle_gate",
        cls_position="head_tail", out_type="avg_featmap"), 0)
    assert tb.cls_token.shape == (1, 2, HIDDEN)
    assert not tb.cls_token.any()
    assert not tb.mixer0.direction_gate.any()
    assert torch.equal(tb.ln2.weight, torch.ones(HIDDEN))
    gate = init_parameters(MultiDirMambaLayer(
        HIDDEN, INTER, "forward_reverse_gate", 9), 0).gate.weight
    assert gate.std() > 0


# --------------------------------------------------------------------------
# float64 train steps against jax.grad
# --------------------------------------------------------------------------

def _grads_close(got, want):
    top = max(float(np.linalg.norm(w)) for w in want.values())
    for k, w in want.items():
        err = float(np.linalg.norm(got[k] - w))
        assert err <= TOL64 * float(np.linalg.norm(w)) + FLOOR64 * top, (
            k, err, float(np.linalg.norm(w)))


@pytest.mark.parametrize("path_type", ["forward_reverse_shuffle_gate",
                                       "forward_reverse_gate"])
def test_float64_step_matches_jax(path_type):
    """One SGD step on sum(out * w): loss, the gradient of every parameter
    and of the input, and the updated parameters."""
    L, lr = 16, 0.1
    x, jl, tree = _layer_case(path_type, L, b=2, seed=7)
    wt = np.random.RandomState(8).randn(*x.shape)
    key = jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        draws = _Draws(L)
        if path_spec(path_type).n_shuffle:
            # the key the layer's one shuffle stream draws, caught outside
            # the jitted gradient
            draws.apply(lambda: jl.apply({"params": params},
                                         method=jl._shuffle_key,
                                         rngs={"shuffle": key}))

        def loss_fn(p, xx):
            out = jl.apply({"params": p}, xx, rngs={"shuffle": key})
            return jnp.sum(out * wt)

        loss, (gp, gx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1)))(params, jnp.asarray(x, jnp.float64))
        want = {k: np.asarray(v, np.float64) for k, v in
                flax_to_state_dict({"params": jax.device_get(gp)},
                                   _load(MultiDirMambaLayer(
                                       HIDDEN, INTER, path_type, L),
                                       tree).double()).items()}
        new = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, gp)
        want_new = flax_to_state_dict(
            {"params": jax.device_get(new)},
            MultiDirMambaLayer(HIDDEN, INTER, path_type, L).double())
    assert len(draws.replay) == path_spec(path_type).n_shuffle
    tl = _load(MultiDirMambaLayer(HIDDEN, INTER, path_type, L).double(),
               tree)
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    with noise.drawing(noise.Replay(draws.replay)):
        got_loss = (tl(xt) * torch.from_numpy(wt)).sum()
    got_loss.backward()
    assert abs(got_loss.item() - float(loss)) <= TOL64 * abs(float(loss))
    got = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    _grads_close(got, want)
    _grads_close({"x": xt.grad.numpy()}, {"x": np.asarray(gx)})
    opt = torch.optim.SGD(tl.parameters(), lr=lr)
    opt.step()
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_new[k].numpy(), rtol=TOL64,
                                   atol=FLOOR64)
