"""speech_tpu_torch: the PyTorch / CUDA port of :mod:`speech_tpu`.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``speech_tpu``: the
numpy-only host modules (aliases, scales, filter banks) are copies, held
array-equal to the originals by the tests.  Module names follow the JAX
package, so each counterpart is easy to find.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from . import alias, config, scales, utils  # noqa: F401
from . import filters, compute  # noqa: F401
from . import ops  # noqa: F401
from . import nn, parallel  # noqa: F401
from . import models, serve  # noqa: F401

__version__ = "0.1.0"
