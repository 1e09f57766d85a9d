from .engine import CapturedStep, Engine, ServeConfig, make_serve_step

__all__ = ["CapturedStep", "Engine", "ServeConfig", "make_serve_step"]
