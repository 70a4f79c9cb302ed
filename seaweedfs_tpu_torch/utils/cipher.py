"""AES-256-GCM chunk encryption (counterpart of
seaweedfs_tpu/utils/cipher.py; SeaweedFS weed/util/cipher.go —
Encrypt/Decrypt with a random key per chunk, key stored in the chunk's
metadata, never on the volume server).

The `cryptography` wheel is preferred; when it is absent (minimal
images) a pure-python AES-GCM fallback keeps cipher-enabled filers
working — chunk-sized payloads only, it is not a bulk-throughput path.
"""

from __future__ import annotations

import os

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ModuleNotFoundError:  # pragma: no cover - depends on image
    AESGCM = None

KEY_SIZE = 32
NONCE_SIZE = 12


def gen_cipher_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(data: bytes, key: bytes) -> bytes:
    """nonce || ciphertext+tag, like cipher.go Encrypt."""
    nonce = os.urandom(NONCE_SIZE)
    if AESGCM is not None:
        return nonce + AESGCM(key).encrypt(nonce, data, None)
    return nonce + _gcm(key, nonce, data, seal=True)


def decrypt(blob: bytes, key: bytes) -> bytes:
    nonce, ct = blob[:NONCE_SIZE], blob[NONCE_SIZE:]
    if AESGCM is not None:
        return AESGCM(key).decrypt(nonce, ct, None)
    return _gcm(key, nonce, ct, seal=False)


# -- pure-python AES-GCM fallback ------------------------------------------
# Textbook FIPS-197 AES + SP 800-38D GCM (96-bit nonces, no AAD — the only
# shape the chunk cipher uses). GHASH multiplies in GF(2^128) with the
# bit-reversed GCM convention. Pinned against a NIST CAVS vector in
# tests/test_crosscutting.py.

_SBOX = None
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D)


def _rotl8(x: int, n: int) -> int:
    return ((x << n) | (x >> (8 - n))) & 0xFF


def _build_sbox() -> bytes:
    inv = [0] * 256
    p = q = 1
    while True:  # walk the multiplicative group with generator 3
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    sbox = bytearray(256)
    for i in range(256):
        x = inv[i] if i else 0
        sbox[i] = (x ^ _rotl8(x, 1) ^ _rotl8(x, 2) ^ _rotl8(x, 3)
                   ^ _rotl8(x, 4) ^ 0x63)
    return bytes(sbox)


def _expand_key(key: bytes) -> list[list[int]]:
    global _SBOX
    if _SBOX is None:
        _SBOX = _build_sbox()
    nk = len(key) // 4
    nr = nk + 6
    words = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        w = list(words[i - 1])
        if i % nk == 0:
            w = [_SBOX[b] for b in w[1:] + w[:1]]
            w[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            w = [_SBOX[b] for b in w]
        words.append([a ^ b for a, b in zip(words[i - nk], w)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(nr + 1)]


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


# ShiftRows index map for column-major (FIPS-197 §3.4) byte order
_SHIFT = tuple((i + 4 * (i % 4)) % 16 for i in range(16))


def _aes_block(round_keys: list[list[int]], block: bytes) -> bytes:
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    nr = len(round_keys) - 1
    for rnd in range(1, nr + 1):
        s = [_SBOX[s[j]] for j in _SHIFT]  # SubBytes + ShiftRows fused
        if rnd != nr:
            t = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                x = a[0] ^ a[1] ^ a[2] ^ a[3]
                t += [a[i] ^ x ^ _xtime(a[i] ^ a[(i + 1) % 4])
                      for i in range(4)]
            s = t
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


def _ghash_mult(x: int, h: int) -> int:
    z = 0
    v = h
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ (0xE1 << 120) if v & 1 else v >> 1
    return z


def _ghash(h: int, data: bytes) -> int:
    y = 0
    for i in range(0, len(data), 16):
        blk = data[i:i + 16].ljust(16, b"\0")
        y = _ghash_mult(y ^ int.from_bytes(blk, "big"), h)
    return y


def _gcm(key: bytes, nonce: bytes, payload: bytes, *, seal: bool) -> bytes:
    rk = _expand_key(key)
    h = int.from_bytes(_aes_block(rk, b"\0" * 16), "big")
    j0 = nonce + b"\x00\x00\x00\x01"  # 96-bit nonce form (SP 800-38D §7.1)

    def ctr(data: bytes) -> bytes:
        out = bytearray()
        counter = int.from_bytes(j0, "big")
        for i in range(0, len(data), 16):
            counter = (counter & ~0xFFFFFFFF) | ((counter + 1) & 0xFFFFFFFF)
            ks = _aes_block(rk, counter.to_bytes(16, "big"))
            out += bytes(a ^ b for a, b in zip(data[i:i + 16], ks))
        return bytes(out)

    if seal:
        ct = ctr(payload)
    else:
        if len(payload) < 16:
            raise ValueError("ciphertext shorter than the GCM tag")
        ct, tag = payload[:-16], payload[-16:]
    lens = (0).to_bytes(8, "big") + (8 * len(ct)).to_bytes(8, "big")
    padded = ct + b"\0" * ((16 - len(ct) % 16) % 16)
    s = _ghash(h, padded + lens)
    want_tag = bytes(a ^ b for a, b in zip(
        s.to_bytes(16, "big"), _aes_block(rk, j0)))
    if seal:
        return ct + want_tag
    import hmac

    if not hmac.compare_digest(want_tag, tag):
        raise ValueError("GCM tag mismatch (wrong key or corrupt data)")
    return ctr(ct)
