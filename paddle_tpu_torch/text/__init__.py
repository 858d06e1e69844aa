"""Text of the port (``paddle_tpu/text`` counterpart): the models of
:mod:`.models`, the sequence ops of :mod:`.ops`, the datasets of
:mod:`.datasets` and :class:`ViterbiDecoder`."""

from . import datasets, models  # noqa: F401
from .datasets import (Imdb, Imikolov, UCIHousing, Movielens,  # noqa: F401
                       Conll05, Conll05st, WMT14, WMT16)
from .ops import (viterbi_decode, edit_distance,  # noqa: F401
                  gather_tree, shard_index)


class ViterbiDecoder:
    """:func:`viterbi_decode` with its transitions fixed. JAX's default
    ``include_bos_eos_tag=True`` is kept, and raises when called, as
    there."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              include_bos_eos_tag=self.include_bos_eos_tag)
