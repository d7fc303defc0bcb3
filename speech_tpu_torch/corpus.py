"""Corpus iterators: post-processing wrappers and a device batch loader.

The counterpart of :mod:`speech_tpu.corpus`.  ``post_process_wrapper`` (a
copy) mirrors the reference's class decorator for
pydrobert-kaldi ``Data`` iterators (reference:
src/pydrobert/speech/corpus.py:30-83): it intercepts ``batch_generator``
and applies per-sub-batch postprocessor chains.  It is duck-typed -- any
class exposing ``batch_generator(repeat=False)`` and ``num_sub`` works.

``FeatureCorpus`` is the device loader: reads utterances on host threads,
buckets them by length, and extracts each batch through
:class:`speech_tpu_torch.parallel.ShardedExtractor` (the computer's fused
CUDA kernel where it selects one; optionally split over a mesh), yielding
host numpy feature arrays -- the streaming corpus analog of the CLI's
batched extraction.
"""

from itertools import cycle
from typing import Optional, Sequence, Tuple, Type, TypeVar

import numpy as np

from .alias import alias_factory_subclass_from_arg
from .post import PostProcessor

__all__ = ["post_process_wrapper", "FeatureCorpus"]

T = TypeVar("T")


def post_process_wrapper(cls: Type[T]) -> Type[T]:
    """Wrap a Data-iterator class with batch post-processing.

    The returned subclass accepts two extra keyword arguments:

    - ``postprocessors``: a sequence of :class:`PostProcessor` configs
      (applied to the whole batch, or sub-batch 0 when ``num_sub > 1``), or
      a mapping ``{sub_batch_idx: sequence}``.
    - ``postprocess_axis``: an int, sequence of ints (zipped cyclically
      against the postprocessors), or mapping thereof.  Defaults to ``-1``.
    """

    class _Wrapper(cls):
        def __init__(self, table, *additional_tables, **kwargs):
            postprocessors = kwargs.pop("postprocessors", dict())
            if not hasattr(postprocessors, "get"):
                postprocessors = {0: postprocessors}
            self.postprocessors = {
                key: tuple(
                    alias_factory_subclass_from_arg(PostProcessor, p)
                    for p in value
                )
                for key, value in postprocessors.items()
            }
            postprocess_axis = kwargs.pop("postprocess_axis", -1)
            if not hasattr(postprocess_axis, "__len__"):
                postprocess_axis = (postprocess_axis,)
            if not hasattr(postprocess_axis, "get"):
                postprocess_axis = {
                    key: postprocess_axis for key in self.postprocessors
                }
            self.postprocess_axis = postprocess_axis
            super().__init__(table, *additional_tables, **kwargs)

        def _apply(self, tensor, sub_batch_idx):
            for postprocessor, axis in zip(
                self.postprocessors.get(sub_batch_idx, tuple()),
                cycle(self.postprocess_axis.get(sub_batch_idx, (-1,))),
            ):
                tensor = postprocessor.apply(tensor, axis=axis, in_place=True)
            return tensor

        def batch_generator(self, repeat=False):
            subsamples = self.num_sub != 1
            for batch in super().batch_generator(repeat=repeat):
                if subsamples:
                    yield tuple(
                        self._apply(sub, idx) for idx, sub in enumerate(batch)
                    )
                else:
                    yield self._apply(batch, 0)

    _Wrapper.__name__ = cls.__name__
    _Wrapper.__qualname__ = cls.__qualname__
    if cls.__doc__:
        _Wrapper.__doc__ = cls.__doc__ + "\n\n(post-process wrapped)"
    return _Wrapper


class FeatureCorpus:
    """Iterate a corpus as bucketed feature batches extracted on the device.

    Parameters
    ----------
    computer
        A frame computer (or config) with a ``compute_batch`` method --
        or ``None`` for feature-file mode, where ``utt2path`` points at
        PRECOMPUTED feature matrices (a ``signals-to-torch-feat-dir``
        output directory, ark entries, ``.npy`` files, ...) and batches
        are read/bucketed without a device extraction stage.  Pair with
        :class:`speech_tpu_torch.nn.FeatureFrontend` to train the model
        families on such batches (extract once, train many).
    utt2path
        Mapping/sequence of ``(utt_id, path)`` pairs.
    batch_size
        Utterances per yielded batch.
    mesh
        Optional :class:`~torch.distributed.device_mesh.DeviceMesh` for
        data-parallel extraction (every process gets every batch).
    preprocessors, postprocessors
        Host processor chains (or configs) applied around computation.
    num_workers
        Host reader threads (0 = read in the iterating thread).
    seed
        Per-utterance RNG seed base for preprocessor determinism.
    sort_by_length
        Bucket utterances by length (within each read window) to minimize
        padding waste.
    window_batches
        Host read window, in batches: utterances are loaded, length-sorted,
        and dispatched ``window_batches * batch_size`` at a time, so host
        memory is bounded by the window rather than the corpus size.
    bucket
        Length-bucket granularity (``"pow2"`` or ``"fine"``), forwarded
        to :class:`~speech_tpu_torch.parallel.ShardedExtractor`.
    """

    def __init__(
        self,
        computer,
        utt2path,
        batch_size: int = 32,
        mesh=None,
        preprocessors: Sequence = (),
        postprocessors: Sequence = (),
        num_workers: int = 0,
        seed: Optional[int] = None,
        sort_by_length: bool = True,
        window_batches: int = 16,
        bucket: str = "pow2",
    ):
        from .compute import FrameComputer
        from .parallel import ShardedExtractor
        from .pre import PreProcessor

        if computer is None:
            # feature-file mode: utt2path points at PRECOMPUTED feature
            # matrices (e.g. a signals-to-torch-feat-dir output dir or
            # ark entries) -- the loader reads, buckets, and batches them
            # without a device extraction stage.  This is the
            # CLI-extraction -> loader -> trainer seam of the Kaldi-style
            # workflow (extract once, train many).
            self.computer = None
            self.extractor = None
        else:
            computer = alias_factory_subclass_from_arg(
                FrameComputer, computer
            )
            self.computer = computer
            self.extractor = ShardedExtractor(computer, mesh, bucket=bucket)
        if hasattr(utt2path, "items"):
            utt2path = list(utt2path.items())
        self.utt2path = list(utt2path)
        self.batch_size = int(batch_size)
        self.preprocessors = [
            alias_factory_subclass_from_arg(PreProcessor, p)
            for p in preprocessors
        ]
        self.postprocessors = [
            alias_factory_subclass_from_arg(PostProcessor, p)
            for p in postprocessors
        ]
        self.num_workers = int(num_workers)
        self.seed = seed
        self.sort_by_length = bool(sort_by_length)
        self.window_batches = max(1, int(window_batches))

    def _load(self, item) -> Tuple[str, np.ndarray]:
        if self.extractor is None:
            # feature-file mode: the path holds a (num_frames, num_coeffs)
            # feature matrix, not audio -- no channel/preprocessor logic
            from .io import read_signal

            idx, (utt_id, path) = item
            feats = np.asarray(
                read_signal(path, dtype=np.float64, key=utt_id)
            )
            if feats.ndim != 2:
                raise IOError(
                    f"Utterance {utt_id}: expected a 2-D feature matrix "
                    f"in feature-file mode, got shape {feats.shape}"
                )
            return utt_id, feats

        from .command_line import _load_utt

        # compact: exact-int16 PCM ships to the device at half width when
        # no host preprocessor touches the samples
        return _load_utt(
            item,
            self.preprocessors,
            -1,
            None,
            self.seed,
            compact=not self.preprocessors,
        )

    def __len__(self) -> int:
        return (len(self.utt2path) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        """Yield ``(utt_ids, [feats_i])`` per batch; each ``feats_i`` is a
        ``(num_frames_i, num_coeffs)`` host numpy float array.

        Host memory stays bounded: utterances are decoded one read window
        (``window_batches * batch_size`` utterances) at a time, sorted by
        length within the window, and streamed through the extractor's
        double-buffered :meth:`ShardedExtractor.extract_iter` so device
        compute overlaps the next window's host IO.
        """
        from collections import deque

        items = list(enumerate(self.utt2path))
        window = self.batch_size * self.window_batches
        if self.num_workers:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.num_workers)
            mapper = pool.map
        else:
            pool, mapper = None, map
        utt_queue = deque()
        try:
            if self.extractor is None:
                # feature-file mode: no device extraction stage
                if self.preprocessors:
                    raise ValueError(
                        "preprocessors operate on raw signals; they do "
                        "not apply in feature-file mode (computer=None)"
                    )
                for wstart in range(0, len(items), window):
                    loaded = list(
                        mapper(self._load, items[wstart : wstart + window])
                    )
                    if self.sort_by_length:
                        loaded.sort(key=lambda uf: len(uf[1]))
                    for start in range(0, len(loaded), self.batch_size):
                        chunk = loaded[start : start + self.batch_size]
                        feats = [
                            np.asarray(f, np.float64) for _, f in chunk
                        ]
                        if self.postprocessors:
                            feats = [self._post(f) for f in feats]
                        yield [u for u, _ in chunk], feats
                return

            def signal_batches():
                for wstart in range(0, len(items), window):
                    loaded = list(
                        mapper(self._load, items[wstart : wstart + window])
                    )
                    if self.sort_by_length:
                        loaded.sort(key=lambda uf: len(uf[1]))
                    for start in range(0, len(loaded), self.batch_size):
                        chunk = loaded[start : start + self.batch_size]
                        utt_queue.append([u for u, _ in chunk])
                        yield [s for _, s in chunk]

            for feats in self.extractor.extract_iter(signal_batches()):
                utts = utt_queue.popleft()
                if self.postprocessors:
                    feats = [
                        self._post(np.asarray(f, np.float64)) for f in feats
                    ]
                yield utts, feats
        finally:
            if pool is not None:
                pool.shutdown()

    def _post(self, feats):
        for p in self.postprocessors:
            feats = p.apply(feats, axis=-1)
        return feats
