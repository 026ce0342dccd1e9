"""Run setup and observability: seeding, logging, profiling, Telegram.

The names ``hyperpocket_tpu/utils/__init__.py`` exports.
"""

from hyperpocket_tpu_torch.utils.logging_setup import logging_setup, seed_setup
from hyperpocket_tpu_torch.utils.telegram import TelegramLogger

__all__ = ["logging_setup", "seed_setup", "TelegramLogger"]
