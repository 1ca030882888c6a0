"""What the validation drivers share: the port's own copies of the JAX
drivers' helpers (``benchmarks/common.py::{taylor_green_velocity,
load_xy_csv, ensure_dir}``, ``soft_disc_in_lid_driven.py::
mean_track_deviation``, ``sedimentation_pack.py::pack_positions``,
``convergence_taylor_green.py::{richardson_order, _sample_ref_on, l2}``;
``make_disc_phi_init`` and ``make_ellipse_phi_init`` are ``ops.levelset``'s
``Disc`` and ``Ellipse``), a run's timing, its progress lines, the
checkpoint of a resumable run, and ``OUTPUTS``: the files each case
writes under ``out_root``, as its JAX driver does (``check_outputs`` holds
a directory against it, ``compare_outputs`` two runs' directories against
each other); ``stop_time`` is ``sim``'s."""
from __future__ import annotations

import fnmatch
import os
import re
from pathlib import Path

import numpy as np
import torch

from pyrmt_tpu_torch.io import (
    STATE_FIELDS,
    EnergyLogger,
    load_checkpoint,
    load_snapshot,
    save_checkpoint,
)
from pyrmt_tpu_torch.sim import stop_time  # noqa: F401  (the drivers' loops)

# the published tracks and tables (data/*.csv at the checkout's root)
DATA_DIR = Path(__file__).resolve().parents[2] / "data"


def torch_dtype(dtype):
    """A torch dtype, given one or the JAX drivers' name of it
    ('float32', 'float64')."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def dtype_name(dtype):
    """The JAX drivers' name of a dtype ('float32', 'float64')."""
    return str(torch_dtype(dtype)).replace("torch.", "")


def ensure_dir(path):
    os.makedirs(path, exist_ok=True)
    return path


def save_table(path, rows, columns):
    """A float table as the JAX drivers write one with ``np.savetxt``: its
    columns' names as the header line, no comment mark."""
    np.savetxt(path, rows, delimiter=",", header=",".join(columns),
               comments="")


def say(verbose, case, **values):
    """One progress line of a case where ``verbose`` (the JAX drivers'
    flag): its name and values."""
    if verbose:
        print(f"[{case}] " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in values.items()), flush=True)


def vortex_velocity(X, Y, U0=1.0):
    """``benchmarks/common.py::taylor_green_velocity`` on numpy coordinates:
    u = U0 k sin(kx) cos(ky), v = -U0 k cos(kx) sin(ky), k = 2 pi."""
    k = 2.0 * np.pi
    return (U0 * k * np.sin(k * X) * np.cos(k * Y),
            -U0 * k * np.cos(k * X) * np.sin(k * Y))


def vortex_state_velocity(cfg, U0, velocity_bc, dtype, device):
    """The drivers' seed: ``vortex_velocity`` on the grid's coordinates in
    ``dtype`` (numpy, as the JAX drivers evaluate it), then the BC."""
    X, Y = cfg.grid.coords(dtype=dtype, device="cpu")
    u0, v0 = vortex_velocity(X.numpy(), Y.numpy(), U0=U0)
    return velocity_bc(torch.as_tensor(u0, dtype=dtype, device=device),
                       torch.as_tensor(v0, dtype=dtype, device=device))


def load_xy_csv(path, has_header=False):
    data = np.loadtxt(path, delimiter=",", skiprows=1 if has_header else 0)
    return data[:, 0], data[:, 1]


def mean_track_deviation(cx, cy, rx, ry):
    """Mean over the centroid samples of the distance to the published
    track's polyline (time-free: the published tracks have no times and
    may cover another span, so the reverse direction would penalise
    unvisited segments rather than the trajectory's error)."""
    ours = np.column_stack([cx, cy])
    A = np.column_stack([rx, ry])[:-1]
    B = np.column_stack([rx, ry])[1:]
    AB = B - A
    denom = (AB * AB).sum(-1).clip(1e-30)
    t = ((ours[:, None, :] - A[None, :, :]) * AB[None, :, :]).sum(-1) \
        / denom[None, :]
    t = np.clip(t, 0.0, 1.0)
    proj = A[None, :, :] + t[:, :, None] * AB[None, :, :]
    d = np.sqrt(((ours[:, None, :] - proj) ** 2).sum(-1)).min(axis=1)
    return float(d.mean())


def pack_positions(S, R):
    """Staggered rows of S centres across the upper half of the unit box."""
    per_row = max(2, int(np.ceil(np.sqrt(S))))
    pos = []
    for k in range(S):
        r, c = divmod(k, per_row)
        x = (c + 1) / (per_row + 1) + (0.5 * R if r % 2 else -0.5 * R)
        y = 0.82 - r * (2.6 * R)
        pos.append((x, y))
    return pos


def sample_ref_on(coarse, ref, key):
    """The reference grid's field ``key`` sampled bilinearly at the coarse
    grid's nodes."""
    from scipy.interpolate import RegularGridInterpolator

    xr = np.linspace(0, 1, ref["N"])
    f = RegularGridInterpolator((xr, xr), ref[key], bounds_error=False,
                                fill_value=None)
    pts = np.column_stack([coarse["Y"].ravel(), coarse["X"].ravel()])
    return f(pts).reshape(coarse["X"].shape)


def l2(err, mask=None):
    if mask is not None:
        err = err[mask]
    return float(np.sqrt(np.mean(err**2)))


def richardson_order(values):
    """Reference-free observed orders from grids spaced by 2: [(N of the
    finest of each triplet, order)]."""
    out = []
    for i in range(len(values) - 2):
        (_, q0), (_, q1), (N2, q2) = values[i], values[i + 1], values[i + 2]
        d_coarse, d_fine = q1 - q0, q2 - q1
        if abs(d_fine) > 0:
            out.append((N2, float(np.log(abs(d_coarse) / abs(d_fine))
                                  / np.log(2.0))))
    return out


# the aux that ``advance`` keeps from the last step that advanced: what the
# stats and the snapshots read of the solid
KEPT = ("phis", "J", "sxx", "sxy", "syy")


def advance(step, state, t_end, n, fold=None, acc=None):
    """``n`` steps of ``step`` toward ``t_end``, as a JAX driver's chunk
    runs them, folding ``acc = fold(acc, state, aux, active)`` after each
    (``active``: the step advanced, dt > 0, a 0-d tensor). Returns (state,
    aux, acc): the last step's aux, its level sets, J and stresses
    (``KEPT``) those of the last step that advanced. Past t_end a step is a
    no-op whose fused-tier aux is its discarded trial step's, at dt = 1
    (JAX's fused path; its XLA path's, the unchanged maps'): a driver's
    stats read the solid as the run left it. Without a no-op step in a
    chunk, the JAX driver's own values."""
    kept = None
    for _ in range(n):
        state, aux = step(state, t_end)
        active = aux["dt"] > 0.0
        if fold is not None:
            acc = fold(acc, state, aux, active)
        if kept is not None:
            aux = dict(aux, **{k: torch.where(active, aux[k], kept[k])
                               for k in KEPT})
        kept = aux
    return state, kept, acc


def timing(steps, wall):
    """A run's steps, wall seconds and steps per second (host clock)."""
    return dict(steps=steps, wall_s=wall,
                steps_per_s=steps / wall if wall > 0 else 0.0)


class Checkpoint:
    """A resumable run's files in ``directory`` (None: no files), as the
    JAX drivers keep them: the state (``checkpoint.npz``,
    ``io.save_checkpoint``, the JAX package's format), the logged rows
    (``csv_name``, whose floats read back exactly) and numpy arrays the run
    needs again (``resume_meta.npz``)."""

    def __init__(self, directory, csv_name):
        self.dir = None if directory is None else ensure_dir(str(directory))
        self.csv_name = csv_name

    def _path(self, name):
        return os.path.join(self.dir, name)

    def load(self, dtype, device):
        """(state, logger, extra arrays), or None where nothing is saved."""
        if self.dir is None or not os.path.exists(
                self._path("checkpoint.npz")):
            return None
        state = load_checkpoint(self._path("checkpoint.npz"), dtype=dtype,
                                device=device)
        csv = self._path(self.csv_name)
        log = (EnergyLogger.from_csv(csv) if os.path.exists(csv)
               else EnergyLogger())
        extra = {}
        if os.path.exists(self._path("resume_meta.npz")):
            with np.load(self._path("resume_meta.npz")) as m:
                extra = {k: m[k] for k in m.files}
        return state, log, extra

    def save(self, state, log):
        """The state and the rows so far."""
        if self.dir is not None:
            save_checkpoint(self._path("checkpoint.npz"), state)
            self.save_rows(log)

    def save_rows(self, log):
        if self.dir is not None:
            log.to_csv(self._path(self.csv_name))

    def save_meta(self, **arrays):
        if self.dir is not None:
            np.savez(self._path("resume_meta.npz"), **arrays)


# What each case writes under ``out_root``, as its JAX driver does: the
# case's directory (a template of the run's values) and each file's name
# (a template too, where it holds the run's values) with its CSV columns
# (a tuple of column sets where they depend on the run) or the keys of
# its npz or snapshot. ``OPTIONAL``'s files are written only on a
# condition: the snapshots at ``snapshot_times``, the convergence field
# cache with ``cache``, the checkpoint every ``ckpt_every`` chunks or at
# ``max_chunks``.
CHECKPOINT_KEYS = STATE_FIELDS
SNAPSHOT_FIELDS = ("phi", "X1", "X2", "a", "b", "p", "J", "sigma_xx",
                   "sigma_xy", "sigma_yy")
SNAPSHOT_ATTRS = ("t", "t_target")
SNAPSHOT = "snap_t{t:05.2f}.h5"
CACHE = "sol_N{N}_{dtype}_t{t_end}_dt{dt}.npz"
CACHE_KEYS = ("N", "dx", "X", "Y", "a", "b", "p", "X1", "X2", "phi", "ke",
              "se")
OUTPUTS = {
    "soft_disc_in_lid_driven": ("soft_disc_lid_N{N}_{scheme}", {
        "centroid.csv": ("t", "cx", "cy", "minJ", "maxJ"),
        SNAPSHOT: SNAPSHOT_FIELDS}),
    "lid_driven_cavity": ("lid_driven_Re{Re}", {
        "centerline_u_vs_y.csv": ("y", "u"),
        # the driver's state, rebuilt with the lid BC, carries no phis0
        "steady_state.npz": ("u", "v", "p", "X1", "X2", "t", "step")}),
    "taylor_green_decay": ("periodic_tg_N{N}{suffix}", {
        "decay.csv": (("t", "ke", "maxdiv"),
                      ("t", "ke", "maxdiv", "xc", "yc"))}),
    "laplace_drop": ("surface_tension_drop_N{N}{suffix}", {
        "laplace_history.csv": ("t", "delta_p", "max_u")}),
    "density_contrast": ("density_contrast_N{N}", {
        "trajectory.csv": ("t", "xc", "yc", "vc", "minJ", "max_div_rel",
                           "cg_iters_max", "cg_iters_mean", "cg_relres")}),
    "disc_in_taylor_green": ("disc_tg_N{N}_{scheme}", {
        "energy_history.csv": ("t", "ke", "se", "dissipation",
                               "integrated_dissipation", "total_energy",
                               "radius_y", "minJ")}),
    "two_disc_contact": ("two_disc_contact_N{N}", {
        "centroids.csv": ("t", "cxa", "cxb", "gap", "minJ")}),
    "two_disc_tg_collision": ("two_disc_tg_N{N}", {
        "centroids.csv": ("t", "cya", "cyb", "gap", "minJ")}),
    "convergence_taylor_green": ("{tag}", {
        "errors.csv": ("dx", "E_v", "E_p", "E_X1", "E_ke", "E_se"),
        CACHE: CACHE_KEYS}),
    "capillary_drop_coupled": ("capillary_drop_N{N}{suffix}", {
        "oscillation.csv": ("t", "aspect", "area", "umax", "minJ",
                            "rebases"),
        "checkpoint.npz": CHECKPOINT_KEYS}),
    "sedimentation_pack": ("sedimentation_N{N}_S{S}", {
        "settling.csv": ("t", "dmin", "ke", "ybar", "minJ", "cg_iters_max",
                         "area_drift"),
        "resume_meta.npz": ("areas0",),
        "checkpoint.npz": CHECKPOINT_KEYS}),
}
OPTIONAL = (SNAPSHOT, CACHE, "checkpoint.npz")


def output_dir(case, out_root, ckpt_dir=None, **values):
    """The directory of ``case``'s files for a run of ``values``:
    ``out_root`` joined with the case's template (the JAX driver's), or
    ``ckpt_dir`` (the resumable cases' own keyword), which must then name
    the same directory (ValueError where not); None with neither. Made
    where missing."""
    d = (None if out_root is None
         else os.path.join(out_root, OUTPUTS[case][0].format(**values)))
    if ckpt_dir is not None:
        if d is not None and (os.path.realpath(d)
                              != os.path.realpath(ckpt_dir)):
            raise ValueError(f"ckpt_dir {ckpt_dir!r} is not the run's "
                             f"directory {d!r} under out_root")
        d = str(ckpt_dir)
    return None if d is None else ensure_dir(d)


def _pattern(template):
    """A file-name template as a glob, a snapshot's ``.h5`` also matching
    the ``.npz`` that ``io.save_snapshot`` writes without h5py."""
    glob = re.sub(r"\{[^}]*\}", "*", template)
    return glob[:-3] + ".*" if glob.endswith(".h5") else glob


def check_outputs(case, directory, rows=None):
    """Hold the files in ``directory`` against ``OUTPUTS[case]``: each
    matches one of the case's file names, each CSV's header is the
    name's column set (one of them) and, where ``rows`` is given, it has
    ``rows`` rows; each npz and snapshot holds exactly its keys (a
    snapshot also ``SNAPSHOT_ATTRS``); each file not in ``OPTIONAL`` is
    there. Returns {file: its rows, or its arrays' shapes}; raises
    ValueError at the first mismatch."""
    files = OUTPUTS[case][1]
    found = {}
    names = sorted(os.listdir(directory))
    for template, want in files.items():
        glob = _pattern(template)
        hits = [n for n in names if fnmatch.fnmatch(n, glob)]
        if not hits and template not in OPTIONAL:
            raise ValueError(f"{case}: no {template} in {directory}")
        for name in hits:
            path = os.path.join(directory, name)
            if name.endswith(".csv"):
                found[name] = _check_csv(case, path, want, rows)
            else:
                found[name] = _check_arrays(case, path, want,
                                            template == SNAPSHOT)
    extra = sorted(set(names) - set(found))
    if extra:
        raise ValueError(f"{case}: files its JAX driver does not write: "
                         f"{extra}")
    return found


def _check_csv(case, path, want, rows):
    header, table = _csv_rows(path)
    header, n = header.rstrip("\r\n").split(","), len(table)
    sets = want if isinstance(want[0], tuple) else (want,)
    if tuple(header) not in sets:
        raise ValueError(f"{case}: {path} has the columns {header}, not "
                         f"{' or '.join(map(str, sets))}")
    if rows is not None and n != rows:
        raise ValueError(f"{case}: {path} has {n} rows, not {rows}")
    return n


def _check_arrays(case, path, want, snapshot):
    if snapshot:
        fields, attrs = load_snapshot(path)
        if set(attrs) != set(SNAPSHOT_ATTRS):
            raise ValueError(f"{case}: {path} has the attributes "
                             f"{sorted(attrs)}, not {SNAPSHOT_ATTRS}")
    else:
        with np.load(path) as z:
            fields = {k: z[k] for k in z.files}
    if set(fields) != set(want):
        raise ValueError(f"{case}: {path} holds {sorted(fields)}, not "
                         f"{sorted(want)}")
    return {k: tuple(v.shape) for k, v in fields.items()}


def compare_outputs(ours, theirs, rtol=1e-10, atol=1e-13, tols=None):
    """Hold the files of one run's directory against another's (the port's
    against its JAX driver's, a card run's against a CPU run's): the same
    file names; each CSV with the same header line and rows; each npz and
    snapshot with the same keys, shapes and attributes; every value
    within ``rtol`` and ``atol`` (``tols``: {column or key: (rtol, atol)}
    where one is held otherwise). Returns the file names; raises
    AssertionError at the first difference."""
    tols = tols or {}
    names = sorted(os.listdir(ours))
    if names != sorted(os.listdir(theirs)):
        raise AssertionError(f"{ours} holds {names}, {theirs} "
                             f"{sorted(os.listdir(theirs))}")

    def close(a, b, key, what):
        r, t = tols.get(key, (rtol, atol))
        np.testing.assert_allclose(a, b, rtol=r, atol=t,
                                   err_msg=f"{what}: {key}")

    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".csv"):
            (ha, ra), (hb, rb) = _csv_rows(a), _csv_rows(b)
            if ha != hb or ra.shape != rb.shape:
                raise AssertionError(f"{name}: {ha} {ra.shape} against "
                                     f"{hb} {rb.shape}")
            for k, key in enumerate(ha.rstrip("\r\n").split(",")):
                close(ra[:, k], rb[:, k], key, name)
            continue
        if fnmatch.fnmatch(name, _pattern(SNAPSHOT)):
            (fa, aa), (fb, ab) = load_snapshot(a), load_snapshot(b)
            if set(aa) != set(ab):
                raise AssertionError(f"{name}: attributes {sorted(aa)} "
                                     f"against {sorted(ab)}")
            for key in aa:
                close(aa[key], ab[key], key, name)
        else:
            with np.load(a) as za, np.load(b) as zb:
                fa = {k: za[k] for k in za.files}
                fb = {k: zb[k] for k in zb.files}
        if set(fa) != set(fb):
            raise AssertionError(f"{name}: {sorted(fa)} against "
                                 f"{sorted(fb)}")
        for key in fa:
            if fa[key].shape != fb[key].shape or (
                    fa[key].dtype != fb[key].dtype):
                raise AssertionError(f"{name}: {key} {fa[key].shape} "
                                     f"{fa[key].dtype} against "
                                     f"{fb[key].shape} {fb[key].dtype}")
            close(fa[key], fb[key], key, name)
    return names


def _csv_rows(path):
    """(the header line as written, the rows as a float array)."""
    with open(path, newline="") as f:
        header = f.readline()
        rows = [line.rstrip("\r\n").split(",") for line in f if line.strip()]
    return header, np.array(rows, dtype=float).reshape(len(rows), -1)
