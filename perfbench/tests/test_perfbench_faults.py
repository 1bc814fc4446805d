"""A run whose timed path is broken underneath comes out not correct:
the harness's own run (its look for a card skipped) at tiny sizes on the
CPU, once for each fault a cell can have. The exchange between chips has
no place in these one-chip cells."""

import time

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import main as M
from perfbench.harness.run import Run
from perfbench.tests import tiny


def _serve(name, **params):
    spec = tiny.spec(name, **params)
    run = Run(spec, 2**31 + 3, 1.5, False, time.perf_counter(), "cpu")
    M.execute(run, cells.driver(spec["cell"]["driver"]))
    return run


SHORT = dict(phones=[10, 30], prompt_tokens=[8, 20])
OFFLINE = dict(SHORT, batch=2, pool_batches=2, in_flight=2, check_batches=2)
ONLINE = dict(SHORT, rate_per_s=4.0, check_requests=3)


@pytest.mark.parametrize("name,params", [("serve_offline_b16", OFFLINE),
                                         ("serve_online_b1", ONLINE)])
def test_sound_serving_run_is_correct(name, params):
    run = _serve(name, **params)
    assert run.correct, run.checks


def _unchanged_step(monkeypatch):
    from promptttspp_tpu_torch.models import diffusion

    monkeypatch.setattr(diffusion.GaussianDiffusion, "p_sample",
                        lambda self, x, t, cond_projs, noise: x)


def _half_batch(monkeypatch):
    from promptttspp_tpu_torch.models import decode_graph

    real = decode_graph.decode

    def half(decoder, cond, *a, **k):
        mel = real(decoder, cond, *a, **k)
        mel[(mel.shape[0] + 1) // 2:] = 0.0
        return mel

    monkeypatch.setattr(decode_graph, "decode", half)


def _altered_answer(monkeypatch):
    from promptttspp_tpu_torch.infer import Synthesizer

    real = Synthesizer._vocode

    def altered(self, mel, f0):
        wav = real(self, mel, f0)
        wav[0, :200] = wav[0, :200] + 0.5
        return wav

    monkeypatch.setattr(Synthesizer, "_vocode", altered)


# half of a batch cannot be left out of a batch of one
@pytest.mark.parametrize("name,params,fault", [
    ("serve_offline_b16", OFFLINE, _unchanged_step),
    ("serve_offline_b16", OFFLINE, _half_batch),
    ("serve_offline_b16", OFFLINE, _altered_answer),
    ("serve_online_b1", ONLINE, _unchanged_step),
    ("serve_online_b1", ONLINE, _altered_answer)])
def test_broken_serving_run_is_not_correct(name, params, fault,
                                           monkeypatch):
    fault(monkeypatch)
    run = _serve(name, **params)
    assert not run.correct, run.checks


def _train(tmpdir_env):
    spec = tiny.train_spec(utterances=40, phones=[13, 30])
    run = Run(spec, 2**31 + 9, 1.0, False, time.perf_counter(), "cpu")
    M.execute(run, cells.driver("train_loop"))
    return run


def test_sound_training_run_is_correct(tmpdir_env):
    run = _train(tmpdir_env)
    assert run.correct, run.checks


def test_training_step_that_leaves_the_state_unchanged(tmpdir_env,
                                                       monkeypatch):
    from promptttspp_tpu_torch.train import state

    real = state.TrainState.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        self.optimizer.step = lambda *a, **k: None

    monkeypatch.setattr(state.TrainState, "__init__", init)
    run = _train(tmpdir_env)
    assert not run.correct
    assert run.checks["change"]["value"] == pytest.approx(1.0)


def test_training_on_half_of_each_batch(tmpdir_env, monkeypatch):
    from promptttspp_tpu_torch.train import state

    real = state.TrainState.train_step

    def half(self, batch):
        n = (batch["phone_lengths"].shape[0] + 1) // 2
        return real(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(state.TrainState, "train_step", half)
    run = _train(tmpdir_env)
    assert not run.correct, run.checks
