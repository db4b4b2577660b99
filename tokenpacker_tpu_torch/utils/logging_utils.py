"""Logging utilities (a copy of `tokenpacker_tpu/utils/logging_utils.py`;
reference llava/utils.py:17-57 behavior): named
loggers with optional daily-rotated file output under LOGDIR."""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

from tokenpacker_tpu_torch.constants import LOGDIR

_handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    global _handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    root = logging.getLogger()
    if not root.handlers:
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(formatter)
        root.addHandler(console)
        root.setLevel(logging.INFO)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None and os.environ.get("TOKENPACKER_LOG_TO_FILE", "0") == "1":
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True, encoding="utf-8"
        )
        _handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    return logger


def disable_torch_init():
    """Reference utils.py:93 parity shim — a no-op here, as in the JAX package
    (kept so ported scripts don't break)."""


MODERATION_MSG = "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."


def violates_moderation(text: str) -> bool:
    """Content-moderation hook (reference llava/utils.py:102-120, called by
    gradio_web_server.py:135 on every user turn). The reference hardcodes the
    OpenAI moderations API; here the endpoint is configurable: set
    MODERATION_URL (plus OPENAI_API_KEY for the hosted API) and the web UI
    checks each user message before dispatching to a worker. Unset = always
    False; request errors fail open, both matching the reference."""
    import json as _json
    import os
    import urllib.request

    url = os.environ.get("MODERATION_URL")
    if not url:
        return False
    headers = {"Content-Type": "application/json"}
    key = os.environ.get("OPENAI_API_KEY")
    if key:
        headers["Authorization"] = "Bearer " + key
    timeout = float(os.environ.get("MODERATION_TIMEOUT", "2"))
    try:  # everything inside: malformed client input must also fail open
        data = _json.dumps({"input": str(text or "").replace("\n", "")}).encode()
        req = urllib.request.Request(url, data, headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return bool(_json.loads(r.read())["results"][0]["flagged"])
    except Exception as e:
        # fail open like the reference, but VISIBLY: silent errors would
        # disable moderation with no operator signal
        logging.getLogger("moderation").warning(
            "moderation check failed (failing open): %r", e
        )
        return False
