"""Embeddings of the port."""

from tfep_tpu_torch.nn.embeddings.radial import (  # noqa: F401
    BehlerParrinelloRadialExpansion, GaussianBasisExpansion,
    behler_parrinello_cosine_switching_function,
)
