"""Former name of :mod:`cpprob_jax`, kept so that existing imports and
``python -m <this name>.cli`` keep working: every module under this name is
the ``cpprob_jax`` module itself.  New code imports ``cpprob_jax``."""

from cpprob_jax._alias import alias_package

alias_package(__name__)
