"""tokenmonster_tpu — an ungreedy tokenizer and vocabulary trainer in JAX.

A from-scratch JAX framework with the capabilities of TokenMonster
(reference: alasdairforsythe/tokenmonster): capcode encoding, flag-based
normalisation, the 6-branch ungreedy tokenizer, the `.vocab`/`.tok`/YAML
formats, vocabulary generation/distillation training, and a drop-in Python
API mirroring the reference binding (python/tokenmonster.py).

Quick start::

    import tokenmonster_tpu as tokenmonster
    vocab = tokenmonster.load("english-32000.vocab")
    ids = vocab.tokenize("some text")
    text = vocab.decode(ids)
"""

from .api import Vocab, load, load_multiprocess_safe, new, set_local_directory

__version__ = "0.1.0"

__all__ = [
    "Vocab", "load", "load_multiprocess_safe", "new", "set_local_directory",
    "__version__",
]
