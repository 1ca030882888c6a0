"""The validation cases from the command line:

    python -m pyrmt_tpu_torch.validation <case> [positionals] [flags]

with the positional arguments and flags of the JAX driver of the same name
(``benchmarks/<case>.py``), among them ``--f64`` (float64; float32
without); ``--cpu`` runs on the CPU (default: the card); ``--out-root DIR``
writes the case's files under DIR as its JAX driver does (the CSV of its
rows, the lid cavity's ``steady_state.npz``, the checkpoints of a
resumable case, which ``--resume`` reads back, the convergence study's
field cache with ``--cache``: ``validation.common.OUTPUTS``). The summary
is printed as one JSON line.

Without ``--out-root`` nothing is written. This departs from the JAX
drivers on purpose: their default, ``outputs/``, holds the JAX package's
committed evidence (``.gitignore`` lists the files kept there), which a
run of the port would overwrite.

    soft_disc_in_lid_driven [N] [scheme] [t_end]
    disc_in_taylor_green [N] [scheme]
    two_disc_contact [N] [t_end] [V0] [k_rep]
    two_disc_tg_collision [N] [t_end] [U0] [k_rep]
    convergence_taylor_green [scheme] [--stress-band] [--full] [--bicubic]
        [--bicubic-raw] [--cache]
    capillary_drop_coupled [N] [--csf] [--kstar] [--hf] [--hf-smooth]
        [--reinit] [--areafix] [--bicubic] [--tend=T] [--rebase[=thr]]
        [--resume]
    sedimentation_pack [N] [S] [--resume]
    periodic_taylor_green [N] [--solid]
    lid_driven_cavity [Re] [N] [--tol TOL] [--resume PATH]
    surface_tension_drop [N] [gamma] [R] [--balanced] [--kstar] [--hf]
        [--hf-smooth]
    density_contrast_disc [N] [ratio]
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pyrmt_tpu_torch import validation as v
from pyrmt_tpu_torch.validation.common import DATA_DIR


def _take(args, flag):
    """Remove ``flag`` and its value from ``args``; the value or None."""
    if flag not in args:
        return None
    i = args.index(flag)
    if i + 1 >= len(args):
        raise SystemExit(f"{flag} needs a value")
    value = args[i + 1]
    del args[i:i + 2]
    return value


def _positional(args, types, defaults):
    """The positional arguments (those not starting with '--') as
    ``types``, ``defaults`` where absent."""
    pos = [a for a in args if not a.startswith("--")]
    if len(pos) > len(types):
        raise SystemExit(f"too many arguments: {pos}")
    return [t(p) for t, p in zip(types, pos)] + list(defaults[len(pos):])


def capillary_overrides(flags):
    """The JAX driver's flags as config overrides, t_end and a tag."""
    over, tag = {}, []
    if "--hf" in flags:
        over["st_curvature"] = "hf"
        tag = ["hf"]
    if "--hf-smooth" in flags:
        over.update(st_curvature="hf", st_hf_smooth=2)
        tag = ["hfsmooth"]
    for flag, key, value, name in (
            ("--reinit", "reinit_method", "fmm", "reinit"),
            ("--areafix", "phi_area_fix", True, "areafix"),
            ("--bicubic", "sl_interp", "bicubic", "bicubic")):
        if flag in flags:
            over[key] = value
            tag.append(name)
    t_end = 4.5
    for a in flags:
        if a.startswith("--tend="):
            t_end = float(a.split("=", 1)[1])
        elif a == "--rebase" or a.startswith("--rebase="):
            thr = float(a.split("=", 1)[1]) if "=" in a else 0.5
            over["map_rebase_minj"] = thr
            tag.append(f"rebase{thr:g}")
    return over, t_end, "_".join(tag)


# each case's flags besides --f64, --cpu and --out-root (a flag ending in
# '=' takes a value after it)
FLAGS = {
    "soft_disc_in_lid_driven": (), "disc_in_taylor_green": (),
    "two_disc_contact": (), "two_disc_tg_collision": (),
    "convergence_taylor_green": ("--stress-band", "--full", "--bicubic",
                                 "--bicubic-raw", "--cache"),
    "capillary_drop_coupled": ("--csf", "--kstar", "--hf", "--hf-smooth",
                               "--reinit", "--areafix", "--bicubic",
                               "--tend=", "--rebase", "--rebase=",
                               "--resume"),
    "sedimentation_pack": ("--resume",),
    "periodic_taylor_green": ("--solid",), "lid_driven_cavity": (),
    "surface_tension_drop": ("--balanced", "--kstar", "--hf", "--hf-smooth"),
    "density_contrast_disc": (),
}


def run(case, args, device, dtype, out_root):
    """The case's summary."""
    if case not in FLAGS:
        raise SystemExit(f"unknown case {case!r}; see the usage:\n{__doc__}")
    kw = dict(dtype=dtype, device=device, out_root=out_root)
    lid = case == "lid_driven_cavity"
    tol = _take(args, "--tol") if lid else None
    resume_from = _take(args, "--resume") if lid else None
    flags = [a for a in args if a.startswith("--")]
    for a in flags:
        if a not in FLAGS[case] and a.split("=")[0] + "=" not in FLAGS[case]:
            raise SystemExit(f"{case} takes no flag {a}")
    if case == "soft_disc_in_lid_driven":
        N, scheme, t_end = _positional(args, (int, str, float),
                                       (128, "semilagrangian", 8.0))
        return v.soft_disc_in_lid_driven(N=N, scheme=scheme, t_end=t_end,
                                         **kw)[1]
    if case == "disc_in_taylor_green":
        N, scheme = _positional(args, (int, str), (128, "semilagrangian"))
        return v.disc_in_taylor_green(N=N, scheme=scheme, **kw)[1]
    if case in ("two_disc_contact", "two_disc_tg_collision"):
        fn = (v.two_disc_contact if case == "two_disc_contact"
              else v.two_disc_tg_collision)
        N, t_end, speed, k_rep = _positional(
            args, (int, float, float, float),
            (128, 2.0) + ((0.15, 2.0) if case == "two_disc_contact"
                          else (0.12, 3.0)))
        speed_kw = "V0" if case == "two_disc_contact" else "U0"
        return fn(N=N, t_end=t_end, k_rep=k_rep, **{speed_kw: speed},
                  **kw)[1]
    if case == "convergence_taylor_green":
        (scheme,) = _positional(args, (str,), ("semilagrangian",))
        grids = dict(grids=(32, 64, 128, 256), N_ref=512) \
            if "--full" in flags else {}
        bicubic = "--bicubic" in flags or "--bicubic-raw" in flags
        return v.convergence_taylor_green(
            scheme=scheme, stress_band="--stress-band" in flags,
            sl_interp="bicubic" if bicubic else "bilinear",
            sl_band_guard=0.0 if "--bicubic-raw" in flags else 3.0,
            cache="--cache" in flags, **grids, **kw)[1]
    if case == "capillary_drop_coupled":
        (N,) = _positional(args, (int,), (128,))
        over, t_end, tag = capillary_overrides(flags)
        return v.capillary_drop_coupled(
            N=N, st_method="csf" if "--csf" in flags else "balanced",
            kappa_interface="--kstar" in flags, t_end=t_end,
            cfg_overrides=over or None, tag=tag,
            resume="--resume" in flags, **kw)[1]
    if case == "sedimentation_pack":
        N, S = _positional(args, (int, int), (256, 10))
        return v.sedimentation_pack(N=N, S=S, resume="--resume" in flags,
                                    **kw)[1]
    if case == "periodic_taylor_green":
        (N,) = _positional(args, (int,), (129,))
        return v.taylor_green_decay(N=N, with_solid="--solid" in flags,
                                    **kw)[1]
    if case == "lid_driven_cavity":
        Re, N = _positional(args, (float, int), (100.0, 129))
        ghia = DATA_DIR / f"plot_u_y_Ghia{Re:g}.csv"
        return v.lid_driven_cavity(
            Re=Re, N=N, ghia_csv=ghia if ghia.exists() else None,
            resume_from=resume_from,
            **({} if tol is None else dict(steady_tol=float(tol))), **kw)
    if case == "surface_tension_drop":
        N, gamma, R = _positional(args, (int, float, float),
                                  (128, 0.1, 0.25))
        smooth = 2 if "--hf-smooth" in flags else 0
        return v.laplace_drop(
            N=N, gamma=gamma, R=R, n_steps=2000,
            st_method="balanced" if "--balanced" in flags else "csf",
            kappa_interface="--kstar" in flags,
            curvature="hf" if "--hf" in flags or smooth else "fd",
            hf_smooth=smooth, **kw)
    N, ratio = _positional(args, (int, float), (128, 10.0))  # density
    return v.density_contrast(N=N, rho_ratio=ratio, t_end=1.0, **kw)[1]


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(val) for k, val in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(val) for val in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    case, args = argv[0], argv[1:]
    out_root = _take(args, "--out-root")
    device = "cpu" if "--cpu" in args else "cuda"
    dtype = torch.float64 if "--f64" in args else torch.float32
    args = [a for a in args if a not in ("--cpu", "--f64")]
    summary = run(case, args, device, dtype, out_root)
    print(json.dumps(dict(case=case, device=device, dtype=str(dtype),
                          **_jsonable(summary))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
