from .env import CommandEnv
from .registry import COMMANDS, run_command

__all__ = ["CommandEnv", "COMMANDS", "run_command"]
