from .transcript import Transcript  # noqa: F401
