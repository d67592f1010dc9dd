"""Masked Autoregressive Flow: MADE conditioner + arbitrary transformer.

Port of ``tfep_tpu/nn/flows/maf.py``: degree validation (consecutive
values from -1/0), embedding-lifted conditioner degrees, identity
initialization through the transformer's identity parameters, and
per-degree-group inverse ordering.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.conditioners.made import MADE
from tfep_tpu_torch.nn.flows.autoregressive import AutoregressiveFlow
from tfep_tpu_torch.nn.transformers.affine import AffineTransformer

__all__ = ['MAF']


class MAF(AutoregressiveFlow):
    """Masked Autoregressive Flow (Papamakarios et al. 2017).

    One MADE conditioner pass produces every transformer parameter in the
    forward (density-evaluation) direction; the inverse iterates one
    conditioner pass per degree group. With ``initialize_identity``
    (default) the untrained flow is exactly the identity map. Build with
    :meth:`create`.
    """

    @classmethod
    def create(cls, generator: torch.Generator, degrees_in, transformer=None,
               hidden_layers: Union[int, list] = 2,
               embedding=None, weight_norm: bool = True,
               initialize_identity: bool = True, device=None,
               dtype: torch.dtype = torch.float32,
               compute_dtype=None) -> 'MAF':
        """Build a MAF layer.

        Parameters
        ----------
        generator : torch.Generator
            CPU generator for the conditioner's initialization.
        degrees_in : array-like of int, shape (n_features,)
            Autoregressive degree per input feature; must take consecutive
            values starting at 0, or -1 for conditioning features (which
            affect the output without being mapped).
        transformer : MAFTransformer, optional
            Defaults to :class:`AffineTransformer`.
        hidden_layers : int | list[int] | list[array], optional
            MADE hidden-layer spec (see :class:`MADE`).
        embedding : nn.Module, optional
            Input lift applied before the conditioner.
        weight_norm : bool, optional
        initialize_identity : bool, optional
        device : str or torch.device, optional
            Defaults to ``cuda``; raises without a card.
        dtype : torch.dtype, optional
            Parameter type.
        compute_dtype : optional
            The JAX package's mixed-precision matmul policy; not ported
            (raises ``NotImplementedError``).
        """
        device = resolve_device(device)
        if transformer is None:
            transformer = AffineTransformer()

        degrees_in = np.asarray(degrees_in)
        min_d, max_d = int(degrees_in.min()), int(degrees_in.max())
        if (set(degrees_in.tolist()) != set(range(min_d, max_d + 1))
                or min_d not in (-1, 0)):
            raise ValueError(
                'degrees_in must assume consecutive values starting from 0 '
                '(or -1 for conditioning input features).')

        if embedding is None:
            degrees_in_embedded = degrees_in
        else:
            degrees_in_embedded = embedding.get_degrees_out(degrees_in)

        # Feature groups in inverse-evaluation order.
        transformer_indices = [np.nonzero(degrees_in == d)[0]
                               for d in range(max_d + 1)]

        # Conditioner output degrees only for transformed inputs.
        degrees_out = transformer.get_degrees_out(degrees_in[degrees_in != -1])

        conditioner = MADE(
            generator, degrees_in=degrees_in_embedded,
            degrees_out=degrees_out, hidden_layers=hidden_layers,
            weight_norm=weight_norm, embedding=embedding, device=device,
            dtype=dtype, compute_dtype=compute_dtype)

        # A parameter row's degree equals its feature's degree, so the rows
        # of degree d are degree group d's transformer parameters, whatever
        # the transformer's layout (the row-restricted inverse).
        inverse_param_rows = [np.nonzero(degrees_out == d)[0]
                              for d in range(max_d + 1)]

        return super().create(
            n_features_in=len(degrees_in),
            transformer_indices=transformer_indices,
            conditioner=conditioner,
            transformer=transformer,
            initialize_identity=initialize_identity,
            inverse_param_rows=inverse_param_rows,
            device=device,
        )

    def n_parameters(self) -> int:
        return self.conditioner.n_parameters()
