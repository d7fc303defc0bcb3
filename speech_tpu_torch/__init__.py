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
from . import corpus, nn, parallel, profiling  # noqa: F401
from . import models, serve  # noqa: F401

# imported on use, as in the JAX package:
#   speech_tpu_torch.torch  (the PyTorch compatibility layer)
#   speech_tpu_torch.vis    (requires matplotlib)
#   speech_tpu_torch.command_line

__version__ = "0.1.0"


def __getattr__(name):
    # deprecated top-level re-exports, mirroring the reference's shim
    # (reference: __init__.py:39-48); canonical home is speech_tpu_torch.alias
    if name in ("AliasedFactory", "alias_factory_subclass_from_arg"):
        import warnings

        warnings.warn(
            f"using {name} from speech_tpu_torch is deprecated; import it "
            "from speech_tpu_torch.alias",
            category=DeprecationWarning,
            stacklevel=2,
        )
        return getattr(alias, name)
    raise AttributeError(f"module 'speech_tpu_torch' has no attribute '{name}'")
