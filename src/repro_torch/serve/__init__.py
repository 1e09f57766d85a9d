from .engine import (CapturedPrefill, CapturedStep, Engine, ServeConfig,
                     make_serve_step)

__all__ = ["CapturedPrefill", "CapturedStep", "Engine", "ServeConfig",
           "make_serve_step"]
