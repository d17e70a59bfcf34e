"""Resumable state of an ``sgd`` run, on the CPU.

The JAX package's ``Trainer.save_resumable`` writes the whole optax state;
for ``sgd`` that is ``add_decayed_weights`` -> ``trace`` ->
``scale_by_learning_rate``. The port writes torch SGD's momentum buffers
as ``opt_state["trace"]`` (a flax ``params`` tree), and nothing at
momentum 0. Held here: EndNet (patch 1, the cheapest model of the
registry) trained in float64 on a tiny Synthetic scene, torch on one
thread:

* 3 unbroken epochs against 2 + ``save_resumable`` + ``restore_resumable``
  (into a trainer of another seed) + 1, equal bit for bit, with momentum
  0.9 and weight decay 1e-2, and at momentum 0 (an empty state);
* the saved trace against optax's ``TraceState.trace`` after the same
  five gradients (the setup of ``test_torch_zoo_train.py::
  test_sgd_matches_the_optax_chain``), within 1e-12;
* a file of one kind of optimizer restored into another raises KeyError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_cnn_tpu.train import optim as jax_optim
from vit_cnn_tpu_torch.convert import state_dict_to_flax
from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.nn.layers import init_parameters
from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig, PatchPipeline
from vit_cnn_tpu_torch.train import checkpoint as ckpt
from vit_cnn_tpu_torch.train.loop import Trainer
from vit_cnn_tpu_torch.train.optim import OptimizerSpec, build_optimizer

BANDS, K = 8, 4
SCENE = {"VCT_SYN_H": "10", "VCT_SYN_W": "12", "VCT_SYN_BANDS": str(BANDS),
         "VCT_SYN_CLASSES": str(K)}
LR = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scene(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    return get_dataset("Synthetic", str(tmp_path))[:3]


def _trainer(scene, optimizer="sgd", momentum=0.0, wd=0.0, seed=0,
             epochs=3):
    """EndNet in float64, flip on, batch 32 (a padded last batch); the
    SGD's momentum set through the Python API (the registry's and the
    Trainer's hyperparameters carry none, as in the JAX package)."""
    img1, img2, gt = scene
    model, _, hp = get_model("EndNet", n_classes=K, n_bands=(BANDS, 1),
                             ignored_labels=[0], batch_size=32,
                             epoch=epochs, lr=LR, optimizer=optimizer,
                             weight_decay=wd)
    init_parameters(model, 0)
    pipe = PatchPipeline(img1, img2, gt, 1, [0], K,
                         augment=AugmentConfig(flip=True))
    pipe.to_compute_dtype(torch.float64)
    assert len(pipe) % 32
    trainer = Trainer(model.double(), hp, pipe, seed=seed,
                      save_checkpoints=False)
    if optimizer == "sgd":
        trainer.optimizer = build_optimizer(
            OptimizerSpec(name="sgd", lr=LR, weight_decay=wd,
                          momentum=momentum), model.parameters())
    return trainer


@pytest.mark.parametrize("momentum,wd", [(0.9, 1e-2), (0.0, 1e-2)])
def test_sgd_resume_reproduces_the_unbroken_run(scene, tmp_path, momentum,
                                                wd):
    whole = _trainer(scene, momentum=momentum, wd=wd)
    whole.fit()

    first = _trainer(scene, momentum=momentum, wd=wd)
    first.epochs = 2
    first.fit()
    path = first.save_resumable(str(tmp_path / "resume" / "sgd"), epoch=2)
    opt_state = ckpt.restore_checkpoint(path)["opt_state"]
    assert set(opt_state) == ({"trace"} if momentum else set())

    rest = _trainer(scene, momentum=momentum, wd=wd, seed=123)
    start = rest.restore_resumable(path)
    assert start == 2 and rest.steps_done == first.steps_done
    rest.fit(start_epoch=start)
    assert rest.log.losses == whole.log.losses[2:]
    want = whole.model.state_dict()
    for k, v in rest.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    if momentum:
        params = dict(rest.model.named_parameters())
        for name, p in whole.model.named_parameters():
            assert torch.equal(rest.optimizer.state[params[name]]
                               ["momentum_buffer"],
                               whole.optimizer.state[p]["momentum_buffer"])
    else:
        assert not rest.optimizer.state


def _trace_leaves(state):
    """The ``trace`` tree of the optax chain's ``TraceState``."""
    traces = [s.trace for s in state if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    return traces[0]


def test_saved_trace_equals_optax_trace(tmp_path):
    """Five steps of torch SGD (momentum 0.9, weight decay 1e-2) and of the
    JAX package's ``build_optimizer`` chain on EndNet's parameters, float64,
    a constant rate, the same gradients: the file's trace equals optax's."""
    model = get_model("EndNet", n_classes=K, n_bands=(BANDS, 1))[0]
    init_parameters(model, 0)
    model.double()
    rng = np.random.RandomState(5)
    named = list(model.named_parameters())
    grads = [{k: torch.tensor(rng.randn(*p.shape)) for k, p in named}
             for _ in range(5)]
    spec = dict(name="sgd", lr=0.1, weight_decay=1e-2, momentum=0.9,
                step_size=None)
    opt = build_optimizer(OptimizerSpec(**spec), model.parameters())
    with jax.enable_x64(True):
        tx = jax_optim.build_optimizer(jax_optim.OptimizerSpec(**spec), 1)
        # copies: the converted arrays share the torch tensors' memory,
        # which the torch steps change in place
        as_jax = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.array(a)), t)
        params = as_jax(state_dict_to_flax(model)["params"])
        state = tx.init(params)
        for g in grads:
            for k, p in named:
                p.grad = g[k]
            opt.step()
            upd, state = tx.update(
                as_jax(state_dict_to_flax(model, g)["params"]), state, params)
            params = optax.apply_updates(params, upd)
        want = jax.tree_util.tree_map(np.asarray, _trace_leaves(state))
    path = ckpt.save_train_state(str(tmp_path / "sgd"), model, opt, 5)
    got = ckpt.restore_checkpoint(path)["opt_state"]["trace"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want) == len(named)
    for key, w in flat_want:
        np.testing.assert_allclose(flat_got[key], w, rtol=0, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(key))
    # and the parameters themselves still agree (the chain's own check)
    got_params = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(model)["params"])[0])
    for key, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_allclose(got_params[key], np.asarray(w),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("wrote,reads", [
    (("adam", 0.0), ("sgd", 0.9)),
    (("sgd", 0.9), ("adam", 0.0)),
    (("sgd", 0.0), ("sgd", 0.9)),
])
def test_restore_into_another_kind_of_optimizer_raises(scene, tmp_path,
                                                       wrote, reads):
    src = _trainer(scene, optimizer=wrote[0], momentum=wrote[1], epochs=1)
    src.fit()
    path = src.save_resumable(str(tmp_path / "ck"), epoch=1)
    dst = _trainer(scene, optimizer=reads[0], momentum=reads[1], epochs=1)
    with pytest.raises(KeyError) as err:
        dst.restore_resumable(path)
    text = str(err.value)
    held = sorted(ckpt.restore_checkpoint(path)["opt_state"])
    assert str(held) in text and type(dst.optimizer).__name__ in text
