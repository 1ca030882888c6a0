"""Each cell run end to end on a CPU at a tiny N through the port's plain
paths: the program agrees with the plain reference to roundoff; the
control (the reference one precision below the configuration's in the
program's place) fails the cell's limits; each fault the cells can have,
planted under the timed path, makes ``correct`` false, the solid block's
maps left unchanged also at the cell's own dt."""
import dataclasses
import time

import pytest
import torch

from fsibench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
CPU = torch.device("cpu")
N = 48
SEED = 2**31 + 77


def run(name, **kw):
    return harness.run_cell(name, SEED, 0.0, False, CPU,
                            time.perf_counter(), N=N, max_chunks=1, **kw)


def own_dt(name):
    """The viscous dt of the cell's own grid, as the step's cap at N: a
    step there moves the maps as far as a step of the cell does."""
    _, config, traffic, _ = harness.cell(name)
    c = config["physics"]
    dx = 1.0 / (traffic["N"] - 1)
    return {"dt_min_cap": c["CFL"] * min(c["rho_s"], c["rho_f"]) * dx**2
            / (4.0 * max(c["mu_f"], c["eta_s"]))}


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_agrees_with_the_reference(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0
    for k, (value, _) in r["checks"].items():
        assert value <= 1e-12, (k, value)
    assert set(r["metrics"]) == {"steps_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cell_s_limits(name):
    r = run(name, control=True)
    limits = harness.cell(name)[3]["limits"]
    over = [k for k, (v, _) in r["control_checks"].items() if v > limits[k]]
    assert over, r["control_checks"]


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, t_end):
        return state, step(state, t_end)[1]
    return broken


def maps_unchanged(step):
    """A step whose solid block returns the maps it took."""
    def broken(state, t_end):
        new, aux = step(state, t_end)
        return dataclasses.replace(new, X1=state.X1, X2=state.X2), aux
    return broken


# how far a fault moves the answer it alters: 5 % of its value
FAULT = 0.05


def altered(field):
    """A step whose answer is altered where it is produced: the cell of
    ``field``'s largest magnitude moved by ``FAULT`` of it."""
    def wrap(step):
        def broken(state, t_end):
            new, aux = step(state, t_end)
            f = getattr(new, field).clone()
            flat = f.view(-1)
            k = int(torch.argmax(flat.abs()))
            flat[k] += FAULT * float(flat[k].abs())
            return dataclasses.replace(new, **{field: f}), aux
        return broken
    return wrap


def map_altered(disc):
    """A step whose map is altered where the solid block produces it: at
    the solid's centre (the map outside the solid is extrapolated anew
    every step), by ``FAULT`` of its value, the block's level set rebuilt
    from it as the block rebuilds it."""
    def wrap(step):
        def broken(state, t_end):
            new, aux = step(state, t_end)
            X1 = new.X1.clone()
            k = torch.argmin(aux["phis"][0]).item()
            j, i = divmod(k, X1.shape[-1])
            X1[0, j, i] *= 1.0 + FAULT
            aux = dict(aux, phis=disc(X1[0], new.X2[0])[None])
            return dataclasses.replace(new, X1=X1), aux
        return broken
    return wrap


FAULTS = ("unchanged", "maps unchanged", "u altered", "p altered",
          "map altered")


def fault(name, kind):
    if kind == "unchanged":
        return unchanged
    if kind == "maps unchanged":
        return maps_unchanged
    if kind == "map altered":
        import pyrmt_tpu_torch as pt

        config = harness.cell(name)[1]
        disc, _ = harness.kind(config).seeded(config, N, SEED)
        return map_altered(pt.Disc(*disc))
    return altered(kind.split()[0])


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_makes_correct_false(name, kind):
    r = run(name, breaker=fault(name, kind))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_maps_left_unchanged_fail_at_the_cell_s_own_dt(name):
    dt = own_dt(name)
    sound = run(name, physics=dt)
    broken = run(name, physics=dt, breaker=maps_unchanged)
    limit = sound["checks"]["maps"][1]
    assert sound["correct"] and sound["checks"]["maps"][0] <= 1e-12
    assert not broken["correct"]
    assert broken["checks"]["maps"][0] > 100 * limit


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reports_what_it_can_read(name):
    r = harness.run_cell(name, 5, 0.0, True, CPU, time.perf_counter(), N=N)
    assert r["correct"]
    # a CPU run has no device events: no device metric
    assert r["metrics"] == {}


@pytest.mark.cuda
def test_on_the_card_a_small_run_is_correct(card):
    r = harness.run_cell(CELLS[0], 11, 0.0, True, card,
                         time.perf_counter(), N=512, max_chunks=1)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    for k in ("device_idle_share", "launches_per_step",
              "rmt_block_roofline", "momentum_rk4_roofline",
              "dct_gemm_ms_per_step"):
        assert k in r["metrics"], k
    assert 0 < r["metrics"]["rmt_block_roofline"]["value"] <= 105
