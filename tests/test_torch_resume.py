"""A run resumed with ``--continue_training`` is the run without a break.

Every epoch of the port's entry points draws from generators of its own,
made from ``(seed, stream, epoch)`` (``train/loop.py::epoch_generator``),
as the JAX package folds the epoch into its run key.  Each case runs a
stage for 2 epochs without a break, then for 1 epoch and resumed to 2, on
the CPU with deterministic algorithms and one thread, every epoch saving (the
best-metric gates are opened), and holds the two runs' draws at every epoch
equal.  The clean classifier, the generator and the victim restore their
optimizers, so their last checkpoints are bit-equal too.  The frequency
detector's resume starts its optimizer anew, as the JAX package's does, so
its draws alone are held.
"""

import itertools

import pytest
import torch

COMMON = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "24", "--bs", "16", "--model", "lenet"]


def _equal(a, b, where="payload"):
    """Bit-equality of two checkpoint payloads, tensors by value."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _record_draws(monkeypatch, module, names):
    """Wrap ``module``'s epoch runners ``names`` so each call appends the
    state of the generator it draws from (positional ``generator`` of the
    training runners, ``generator=`` of ``eval_epoch``) to a list."""
    seen = []

    def wrap(name, fn):
        def runner(*args, **kw):
            gen = kw.get("generator") if name == "eval_epoch" else next(
                a for a in args if isinstance(a, torch.Generator))
            seen.append((name, None if gen is None else gen.get_state()))
            return fn(*args, **kw)
        return runner

    for name in names:
        monkeypatch.setattr(module, name, wrap(name, getattr(module, name)))
    return seen


@pytest.fixture
def deterministic():
    torch.set_num_threads(1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _stage(case, root):
    """(main, module whose runners draw, runner names, argv without
    ``--n_iters``, checkpoint path of prefix) for ``case``; the stages it
    loads are trained first, one epoch each."""
    from combat_tpu_torch.checkpoint import ckpt_path
    from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier, train_generator, train_victim
    from combat_tpu_torch.defenses import frequency_train

    ck = ["--checkpoints", str(root)]
    if case == "frequency_train":
        argv = lambda p: COMMON + ["--F_model", "original", "--F_checkpoints", str(root / p)]  # noqa: E731
        path = lambda p: str(root / p / "cifar10/original/cifar10_original_detector.pt")  # noqa: E731
        return frequency_train.main, frequency_train, ("train_epoch_classifier", "eval_epoch"), argv, path
    train_clean_classifier.main(COMMON + ck + ["--n_iters", "1", "--saving_prefix", "cl"])
    if case == "clean":
        argv = lambda p: COMMON + ck + ["--saving_prefix", p]  # noqa: E731
        path = lambda p: ckpt_path(str(root), p, "cifar10")  # noqa: E731
        return train_clean_classifier.main, train_clean_classifier, ("train_epoch_classifier",), argv, path
    gen = COMMON + ck + ["--load_checkpoint_clean", "cl"]
    path = lambda p: ckpt_path(str(root), f"{p}_clean", "cifar10")  # noqa: E731
    if case == "generator":
        argv = lambda p: gen + ["--saving_prefix", p]  # noqa: E731
        return train_generator.main, _alternated, ("train_epoch_alternated", "eval_epoch"), argv, path
    train_generator.main(gen + ["--n_iters", "1", "--saving_prefix", "atk"])
    argv = lambda p: COMMON + ck + ["--load_checkpoint", "atk_clean", "--saving_prefix", p]  # noqa: E731
    return train_victim.main, _victim, ("train_epoch_classifier", "eval_epoch"), argv, path


@pytest.mark.parametrize("case", ["clean", "generator", "victim", "frequency_train"])
def test_resumed_run_is_the_run_without_a_break(case, tmp_path, monkeypatch, deterministic):
    from combat_tpu_torch.checkpoint import load_checkpoint
    from combat_tpu_torch.cli import _alternated, _victim, train_clean_classifier

    for module, gate in ((train_clean_classifier, "best_gate_clean"), (_alternated, "best_gate_attack"),
                         (_victim, "best_gate_clean")):
        monkeypatch.setattr(module, gate, lambda *a: True)
    main, module, runners, argv, path = _stage(case, tmp_path)
    draws = _record_draws(monkeypatch, module, runners)

    main(argv("u") + ["--n_iters", "2"])
    unbroken, draws[:] = list(draws), []
    main(argv("r") + ["--n_iters", "1"])
    assert load_checkpoint(path("r"))["epoch_current"] == 0
    main(argv("r") + ["--n_iters", "2", "--continue_training"])
    resumed = list(draws)

    assert [name for name, _ in resumed] == [name for name, _ in unbroken]
    for i, ((name, a), (_, b)) in enumerate(zip(unbroken, resumed)):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f"draw {i} ({name})"
    if case != "frequency_train":
        got, want = load_checkpoint(path("r")), load_checkpoint(path("u"))
        assert got["epoch_current"] == want["epoch_current"] == 1
        _equal(got, want)


def test_epoch_seeds_are_distinct():
    """No two (seed, stream, epoch) triples share a torch seed over seeds,
    every stream and epochs of a run; a sum would (seed 1 at epoch 1 is seed
    2 at epoch 0).  Each seed is a 64-bit word."""
    from combat_tpu_torch.train import DETECTOR_EVAL_STREAM, EVAL_STREAM, GRID_STREAM, TRAIN_STREAM, epoch_seed

    streams = (TRAIN_STREAM, DETECTOR_EVAL_STREAM, EVAL_STREAM, GRID_STREAM)
    seeds = list(range(32)) + [2**20 - 1, 2**31 - 1, 2**63 + 5]
    triples = list(itertools.product(seeds, streams, range(1000)))
    values = [epoch_seed(*t) for t in triples]
    assert len(set(values)) == len(triples)
    assert all(0 <= v < 2**64 for v in values)
    assert epoch_seed(1, TRAIN_STREAM, 1) != epoch_seed(2, TRAIN_STREAM, 0)
    assert epoch_seed(1, EVAL_STREAM, 0) != epoch_seed(1, TRAIN_STREAM, EVAL_STREAM)
