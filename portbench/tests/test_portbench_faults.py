"""A run with the timed path broken underneath comes out not correct,
once for each fault a sweep cell can have: a tick that returns its state
unchanged; half of the batch left out, its lanes given the mean of the
rest; an answer altered where it is produced (a bill, and the packer's
draw of one job); a result dropped. (A sweep cell runs on one chip, so
it has no exchange between chips to leave out.)"""

import dataclasses

import numpy as np
import pytest

from helpers import run_tiny, tiny_tree


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("faults"))


def unchanged_state(mp):
    from repro_torch.sim import batched

    real = batched._lane_step_fns

    def fns(*a, **kw):
        tick_fn, post_fn = real(*a, **kw)

        def frozen(st, c):
            st["tick"].add_(1)

        return frozen, post_fn

    mp.setattr(batched, "_lane_step_fns", fns)


def half_batch(mp):
    from repro_torch.sim import batched

    real = batched._simulate

    def simulate(grid, *a, **kw):
        out, *rest = real(grid, *a, **kw)
        half = grid.n_lanes // 2
        for k, v in out.items():
            v[half:] = v[:half].mean(axis=0).astype(v.dtype)
        return (out, *rest)

    mp.setattr(batched, "_simulate", simulate)


def altered_bill(mp):
    from repro_torch.sim import batched

    real = batched._lane_result

    def lane_result(grid, out, si, *a, **kw):
        r = real(grid, out, si, *a, **kw)
        if si == 3:
            r.storage_usd *= 1.01
        return r

    mp.setattr(batched, "_lane_result", lane_result)


def altered_draw(mp):
    from repro_torch.sim import batched

    real = batched.pack_specs

    def pack(specs, **kw):
        grid = real(specs, **kw)
        n_jobs = grid.n_jobs.copy()
        n_jobs[0, 0] -= 1
        return dataclasses.replace(grid, n_jobs=n_jobs)

    mp.setattr(batched, "pack_specs", pack)


def dropped_result(mp):
    from repro_torch.sim import batched

    real = batched.SweepResult

    def result(results, **kw):
        return real(results=results[:-1], **kw)

    mp.setattr(batched, "SweepResult", result)


@pytest.mark.parametrize("fault, number", [
    (unchanged_state, "gap"), (half_batch, "gap"), (altered_bill, "gap"),
    (altered_draw, "draws_off"), (dropped_result, "missing")])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault,
                                            number):
    fault(monkeypatch)
    line = run_tiny(root, seed=2 ** 32 + 9)
    assert line["correct"] is False
    c = line["compared"][number]
    assert c["value"] > c["limit"], line["compared"]


def test_the_sound_path_is_correct(root):
    line = run_tiny(root, seed=2 ** 32 + 9)
    assert line["correct"] is True
    assert np.isfinite(line["compared"]["gap"]["value"])
