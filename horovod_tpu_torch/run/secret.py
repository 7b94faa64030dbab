"""HMAC secrets for authenticating the control-plane RPC: the port's copy
of ``horovod_tpu/run/secret.py`` (reference
horovod/run/common/util/secret.py:21-36)."""

import hashlib
import hmac
import os

SECRET_LENGTH = 32
DIGEST_LENGTH = 32
# Env var used to hand the key from the launcher to spawned tasks.
HVD_SECRET_KEY = "_HVD_SECRET_KEY"


def make_secret_key() -> bytes:
    return os.urandom(SECRET_LENGTH)


def compute_digest(key: bytes, message: bytes) -> bytes:
    return hmac.new(key, message, hashlib.sha256).digest()


def check_digest(key: bytes, message: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(compute_digest(key, message), digest)
