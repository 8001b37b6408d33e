"""Device-side phred -> average error rate reduction.

Device equivalent of _fastqmodule.c:38-76: a 128-entry error-rate LUT
gather plus a masked mean per record.  The pipeline's pass-1 quality filter
uses it when ``FASTQDEDUP_DEVICE_QUALITY=1`` (see pipeline.py); the default
is the bit-exact float64 host reduction in ``fastqdedup_tpu.quality``, which
preserves the reference's IEEE rounding sequence on threshold comparisons
and its strict character-range validation.  This kernel is the
high-throughput f32 counterpart for hosts whose CPU is the bottleneck.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..quality import DEFAULT_PHRED_OFFSET, SCORE_TO_ERROR_RATE

_LUT_F32 = SCORE_TO_ERROR_RATE.astype(np.float32)  # captured as a constant


@functools.partial(jax.jit, static_argnames=("phred_offset",))
def batch_average_error_rate_device(
        scores: jax.Array, lengths: jax.Array,
        phred_offset: int = DEFAULT_PHRED_OFFSET) -> jax.Array:
    """float32 [B] average error rates over padded phred byte rows.

    ``scores``: uint8 [B, Lmax]; ``lengths``: int32 [B] valid prefix sizes.
    Padding bytes are masked out of the mean.
    """
    lmax = scores.shape[1]
    idx = (scores.astype(jnp.int32) - phred_offset) & 0x7F
    rates = jnp.asarray(_LUT_F32)[idx]
    mask = jnp.arange(lmax, dtype=jnp.int32)[None, :] < \
        lengths.astype(jnp.int32)[:, None]
    totals = jnp.sum(jnp.where(mask, rates, 0.0), axis=1)
    return totals / lengths.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("phred_offset",))
def quality_filter_mask(scores: jax.Array, lengths: jax.Array,
                        max_average_error_rate: jax.Array,
                        phred_offset: int = DEFAULT_PHRED_OFFSET
                        ) -> jax.Array:
    """bool [B]: True for records that PASS the quality filter.

    The reference discards on ``rate > threshold`` (__init__.py:247-249),
    which KEEPS records whose rate is NaN (empty quality string: 0.0/0.0,
    _fastqmodule.c:73-75) — so the pass mask is ``~(rate > threshold)``,
    not ``rate <= threshold``."""
    rates = batch_average_error_rate_device(scores, lengths, phred_offset)
    return ~(rates > max_average_error_rate)
