"""The model zoo (counterpart of ``paddle_tpu/models/``): each ``build``
takes the JAX package's signature and defaults and writes the same
programs, byte for byte."""

from . import bert, deepfm, fit_a_line, label_semantic_roles  # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist, recommender, resnet, se_resnext  # noqa: F401
from . import stacked_lstm, transformer, understand_sentiment  # noqa: F401
from . import vgg, word2vec  # noqa: F401
