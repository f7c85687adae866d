"""Global config + logging setup (counterpart of
pyaudiorestoration_tpu/utils/config.py; reference: util/config.py).

``config_path()`` names the same ``config.json`` at the checkout root as the
JAX package, so either package reads the other's settings.
"""

from __future__ import annotations

import json
import logging
import os
import sys

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config_path():
    return os.path.join(ROOT_DIR, "config.json")


def save_json(json_path, dic):
    logging.info(f"Saving {os.path.basename(json_path)}")
    try:
        with open(json_path, "w") as w:
            json.dump(dic, w, indent="\t", sort_keys=True)
    except OSError:
        logging.exception("Saving failed, perhaps lack of disk space")


def load_json(json_path):
    try:
        with open(json_path, "r") as r:
            return json.load(r)
    except FileNotFoundError:
        return {}


def save_config(cfg_dict):
    save_json(config_path(), cfg_dict)


def load_config():
    return load_json(config_path())


def logging_setup(log_name="pyaudiorestoration"):
    """INFO console + DEBUG file logging (config.py:35-49)."""
    log_path = f"{log_name}.log"
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter("%(levelname)s | %(message)s")
    stdout_handler = logging.StreamHandler(sys.stdout)
    stdout_handler.setLevel(logging.INFO)
    stdout_handler.setFormatter(formatter)
    file_handler = logging.FileHandler(log_path, mode="w")
    file_handler.setLevel(logging.DEBUG)
    file_handler.setFormatter(formatter)
    logger.addHandler(file_handler)
    logger.addHandler(stdout_handler)
