"""Architecture registry of the port: importing this package registers every
config the port serves. Later slices add the other architectures of
``repro/configs`` as their model families are ported."""
from . import qwen3_1_7b  # noqa: F401
from .shapes import smoke_config  # noqa: F401
