"""Audio of the port (``paddle_tpu/audio`` counterpart): mel and window
math (:mod:`.functional`), the feature layers (:mod:`.features`), WAV IO
(:mod:`.backends`) and the synthetic datasets (:mod:`.datasets`)."""

from . import backends, datasets, features, functional  # noqa: F401
from .backends import info, load, save  # noqa: F401
