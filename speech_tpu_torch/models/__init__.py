"""Model families: the feature computers and trainable frontends.

The counterpart of :mod:`speech_tpu.models`: the configurable feature
extractors (:mod:`speech_tpu_torch.compute`), their learnable counterparts
(:mod:`speech_tpu_torch.nn`), the downstream families built on them
(keyword spotting, speaker embeddings, CTC) as :class:`torch.nn.Module` s,
their train-state checkpoints, and the named preset recipes
(``create("fbank-80-16k")``, ``preset_config(name)``).

Parameters of every family carry the JAX package's ``params`` keys as their
dotted names; :func:`params_from_jax` loads the JAX package's values (or
an ``.npz`` that either package's ``save_params`` wrote).
"""

from ..compute import (  # noqa: F401
    FrameComputer,
    LinearFilterBankFrameComputer,
    ShortIntegrationFrameComputer,
    ShortTimeFourierTransformFrameComputer,
    SIFrameComputer,
    STFTFrameComputer,
    frame_by_frame_calculation,
)
from ..nn import STFTFrontend  # noqa: F401
from ._common import load_params, params_from_jax, save_params  # noqa: F401
from .checkpoint import TrainCheckpointer  # noqa: F401
from .kws import (  # noqa: F401
    ConvClassifier,
    KWSModel,
    StreamingKWS,
    make_train_step,
)
from .ctc import (  # noqa: F401
    CTCModel,
    TransformerEncoder,
    beam_search_decode,
    greedy_decode,
)
from .presets import PRESETS, create, preset_config  # noqa: F401
from .speaker import (  # noqa: F401
    SpeakerModel,
    StreamingSpeaker,
    TDNNEncoder,
    aam_softmax_loss,
    cosine_scores,
)
from ..streaming import (  # noqa: F401
    SIStreamState,
    StreamingSI,
    StreamingSTFT,
    StreamState,
)

__all__ = [
    "PRESETS",
    "CTCModel",
    "ConvClassifier",
    "KWSModel",
    "SpeakerModel",
    "StreamingKWS",
    "StreamingSpeaker",
    "TDNNEncoder",
    "TrainCheckpointer",
    "TransformerEncoder",
    "aam_softmax_loss",
    "beam_search_decode",
    "cosine_scores",
    "greedy_decode",
    "create",
    "make_train_step",
    "preset_config",
    "params_from_jax",
    "FrameComputer",
    "LinearFilterBankFrameComputer",
    "ShortIntegrationFrameComputer",
    "ShortTimeFourierTransformFrameComputer",
    "SIFrameComputer",
    "STFTFrameComputer",
    "STFTFrontend",
    "StreamingSI",
    "SIStreamState",
    "StreamingSTFT",
    "StreamState",
    "frame_by_frame_calculation",
]
