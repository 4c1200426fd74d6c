from .schedule import Schedule, build_schedule, exponential_sqrt_etas, space_timesteps
from . import ddpm, resshift

__all__ = ["Schedule", "build_schedule", "exponential_sqrt_etas", "space_timesteps", "ddpm",
           "resshift"]
