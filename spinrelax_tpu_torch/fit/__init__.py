from . import lm, expfit, legacy_expfit  # noqa: F401
