"""The JAX package's validation drivers (``benchmarks/*.py``), as functions
of the port: each takes its driver's ``run``'s parameters (in its order up
to ``out_root``), runs on the card unless ``device='cpu'`` and returns
what its driver's ``run`` returns. With ``out_root`` a case writes its
driver's files there (``common.OUTPUTS``: the rows' CSV, snapshots, the
lid cavity's steady state, checkpoints, the convergence cache), which
``pyrmt_tpu_torch.analysis`` reads; with ``out_root=None`` (the default)
nothing is written.

One module a driver, as ``benchmarks/`` has one file a driver:

- ``gates``: the periodic Taylor-Green decay, Ghia's lid-driven cavity,
  Laplace's static drop and the density-contrast disc
  (``taylor_green_decay``, ``lid_driven_cavity``, ``laplace_drop``,
  ``density_contrast``);
- ``soft_disc``: the soft disc in the lid-driven cavity against Sugiyama's
  and Kolahduz's tracks (``soft_disc_in_lid_driven``);
- ``disc_in_taylor_green``: the disc in a Taylor-Green vortex, its total
  energy's drift;
- ``two_disc_contact``: the head-on collision, no pass-through and the
  rebound;
- ``two_disc_tg_collision``: two discs driven together by a vortex;
- ``convergence_taylor_green``: the spatial convergence study
  (``simulate_tg``, the observed and Richardson orders);
- ``capillary_drop_coupled``: the ringing elliptic drop against
  Rayleigh's period;
- ``sedimentation_pack``: S heavy discs settling through the
  variable-density CG;
- ``common``: the drivers' helpers (the port's own copies of
  ``benchmarks/common.py``'s and the drivers').

``python -m pyrmt_tpu_torch.validation <case> [args]`` runs a case from
the command line with its JAX driver's arguments and prints its summary
as one JSON line."""
from pyrmt_tpu_torch.validation.capillary_drop_coupled import (  # noqa: F401
    capillary_drop_coupled,
)
from pyrmt_tpu_torch.validation.convergence_taylor_green import (  # noqa: F401
    convergence_taylor_green,
    simulate_tg,
)
from pyrmt_tpu_torch.validation.disc_in_taylor_green import (  # noqa: F401
    disc_in_taylor_green,
)
from pyrmt_tpu_torch.validation.gates import (  # noqa: F401
    DENSITY_DISC,
    density_contrast,
    density_contrast_config,
    laplace_drop,
    lid_cavity_config,
    lid_cavity_state,
    lid_driven_cavity,
    taylor_green_config,
    taylor_green_decay,
    taylor_green_velocity,
)
from pyrmt_tpu_torch.validation.sedimentation_pack import (  # noqa: F401
    sedimentation_pack,
)
from pyrmt_tpu_torch.validation.soft_disc import (  # noqa: F401
    soft_disc_in_lid_driven,
)
from pyrmt_tpu_torch.validation.two_disc_contact import (  # noqa: F401
    two_disc_contact,
)
from pyrmt_tpu_torch.validation.two_disc_tg_collision import (  # noqa: F401
    two_disc_tg_collision,
)
