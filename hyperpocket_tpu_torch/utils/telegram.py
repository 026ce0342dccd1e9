"""Fire-and-forget Telegram notifications (reference utils/telegram_logging.py).

A copy of ``hyperpocket_tpu/utils/telegram.py`` (``requests``, imported at use).

All network errors are swallowed — a Telegram outage must never kill a
training run (telegram_logging.py:31-32,48-49).
"""

from __future__ import annotations

import logging


class TelegramLogger:
    _instance: "TelegramLogger | None" = None

    def __init__(self, bot_token: str, chat_id: str):
        self.bot_token = bot_token
        self.chat_id = chat_id
        self._log = logging.getLogger(__name__)

    @classmethod
    def get_logger(cls, config: dict) -> "TelegramLogger":
        if cls._instance is None:
            cls._instance = cls(config["bot_token"], config["chat_id"])
        return cls._instance

    def log(self, text: str) -> None:
        try:
            import requests

            requests.post(
                f"https://api.telegram.org/bot{self.bot_token}/sendMessage",
                data={"chat_id": self.chat_id, "text": text},
                timeout=10,
            )
        except Exception as exc:  # never propagate
            self._log.debug("telegram log failed: %s", exc)

    def log_images(self, image_paths: list[str], caption: str = "") -> None:
        try:
            import json as _json

            import requests

            media = [
                {"type": "photo", "media": f"attach://img{i}", **({"caption": caption} if i == 0 else {})}
                for i in range(len(image_paths))
            ]
            files = {f"img{i}": open(p, "rb") for i, p in enumerate(image_paths)}
            try:
                requests.post(
                    f"https://api.telegram.org/bot{self.bot_token}/sendMediaGroup",
                    data={"chat_id": self.chat_id, "media": _json.dumps(media)},
                    files=files,
                    timeout=30,
                )
            finally:
                for fh in files.values():
                    fh.close()
        except Exception as exc:  # never propagate
            self._log.debug("telegram image log failed: %s", exc)
