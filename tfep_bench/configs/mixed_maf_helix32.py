"""The flagship map, ``MixedMAFMap``, on a bonded 32-atom carbon helix.

The frames are the helix of ``mixed_maf_helix32.json`` with Gaussian noise,
drawn on the device from the run's seed; the program receives them as a
``System`` on the host, as a user's trajectory. The target is harmonic,
``0.5 kT |y|^2`` in kcal/mol at 300 K.
"""

from __future__ import annotations

import torch

from tfep_bench.molecules import helix_frames
from tfep_bench.targets import HarmonicPotential


def bonds(cfg):
    n = int(cfg['n_atoms'])
    return [(i, i + 1) for i in range(n - 1)]


def frames(cfg, n, seed, device):
    """``(n, 3 n_atoms)`` float32 frames on ``device`` from the seed."""
    return helix_frames(cfg, n, seed, device)


def build_map(cfg, traffic, host_frames, device, logger_dir=None):
    """The program's map over ``host_frames``, not yet set up; it logs
    the work values under ``logger_dir`` if one is given."""
    from tfep_tpu_torch.app import MixedMAFMap
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System
    from tfep_tpu_torch.units import ureg

    n = int(cfg['n_atoms'])
    topology = Topology(names=[f'C{i}' for i in range(n)],
                        elements=['C'] * n, bonds=bonds(cfg))
    system = System(topology, host_frames.reshape(len(host_frames), n, 3))
    batch = traffic.get('batch', traffic.get('eval_batch'))
    return MixedMAFMap(
        potential_energy_func=HarmonicPotential(cfg['temperature_K']),
        temperature=cfg['temperature_K'] * ureg.kelvin, system=system,
        batch_size=int(batch), tfep_logger_dir_path=logger_dir,
        n_maf_layers=int(cfg['n_maf_layers']), n_bins=int(cfg['n_bins']),
        device=device, dtype=getattr(torch, cfg['dtype']))


def port_name(key):
    """The program's name of a reference weight."""
    layer, linear, leaf = key.split('.')
    return f'flow.flows.{layer[3:]}.conditioner.layers.{linear}.{leaf}'
