"""Post-processing of the validation cases' files (the port's counterpart
of ``benchmarks/analysis/``, ``benchmarks/plot_soft_disc_panels.py`` and
``helper/{simulation,lid_driven}_gif.py``): read what
``pyrmt_tpu_torch.validation`` writes under ``out_root`` (or what
``io.output_simulation_data`` writes) and draw the JAX package's figures.

- ``common``: the readers (frames, snapshots, CSV columns, centroid and
  area of a level set); they need numpy alone and run on any machine;
- ``plot_centroid``, ``plot_energy``, ``plot_fields``, ``plot_lid_driven``,
  ``plot_soft_disc_panels``: figures as PNG;
- ``simulation_gif``, ``lid_driven_gif``: movies (GIF or MP4 with
  imageio, else PNG frames).

Every script runs as ``python -m pyrmt_tpu_torch.analysis.<script> ...``.
matplotlib and imageio are imported only inside the functions that draw,
so the readers work where neither is installed (the card's machine)."""
from pyrmt_tpu_torch.analysis.common import (  # noqa: F401
    frame_grid,
    get_area,
    get_centroid,
    list_frames,
    load_csv,
    load_energy_csv,
    load_frame,
)
