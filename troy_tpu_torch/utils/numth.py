"""Host-side number theory on Python ints.

Copy of troy_tpu/utils/numth.py, so that the PyTorch port imports nothing of
the JAX package; tests/test_torch_context.py holds the two to the same
primes, roots and ParmsIDs, and tests/test_torch_galois.py to the same NAF.  Nothing here runs in
the hot path.
"""

from __future__ import annotations


# Deterministic Miller-Rabin witnesses, valid for all n < 3.3e24 (covers u64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64 (ref: uint_small_mod.h:264)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd -> (g, x, y) with a*x + b*y = g (ref: number_theory.h:28)."""
    x0, x1, y0, y1 = 1, 0, 0, 1
    while b:
        q, a, b = a // b, b, a % b
        x0, x1 = x1, x0 - q * x1
        y0, y1 = y1, y0 - q * y1
    return a, x0, y0


def invert_mod(a: int, m: int) -> int:
    """Modular inverse; raises ValueError if not invertible (ref: number_theory.h:46)."""
    g, x, _ = xgcd(a % m, m)
    if g != 1:
        raise ValueError(f"[numth.invert_mod] {a} not invertible mod {m}")
    return x % m


def gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def are_coprime(a: int, b: int) -> bool:
    return gcd(a, b) == 1


def get_primes(factor: int, bit_size: int, count: int) -> list[int]:
    """`count` distinct primes of exactly `bit_size` bits, each ≡ 1 (mod factor),
    in decreasing order (ref: number_theory.cu get_primes).

    For NTT support pass factor = 2n.
    """
    if bit_size < 2 or bit_size > 61:
        raise ValueError(f"[numth.get_primes] unsupported bit_size {bit_size}")
    out: list[int] = []
    # Largest candidate of this bit size that is ≡ 1 mod factor.
    value = ((1 << bit_size) - 1) // factor * factor + 1
    lower = 1 << (bit_size - 1)
    while value > lower:
        if is_prime(value):
            out.append(value)
            if len(out) == count:
                return out
        value -= factor
    raise ValueError(
        f"[numth.get_primes] not enough {bit_size}-bit primes ≡ 1 mod {factor}"
    )


def get_prime(factor: int, bit_size: int) -> int:
    return get_primes(factor, bit_size, 1)[0]


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """Is `root` a primitive degree-th root of unity mod prime modulus?
    degree must be a power of two (ref: number_theory.cu is_primitive_root)."""
    if root == 0:
        return False
    return pow(root, degree // 2, modulus) == modulus - 1


def try_primitive_root(degree: int, modulus: int) -> int | None:
    """Find any primitive degree-th root of unity mod prime `modulus`
    (degree a power of 2, degree | modulus-1)."""
    group_size = modulus - 1
    if group_size % degree != 0:
        return None
    quotient = group_size // degree
    import random

    for _ in range(200):
        candidate = pow(random.randrange(1, modulus), quotient, modulus)
        if is_primitive_root(candidate, degree, modulus):
            return candidate
    return None


_min_root_cache: dict[tuple[int, int], int | None] = {}


def try_minimal_primitive_root(degree: int, modulus: int) -> int | None:
    """Minimal primitive degree-th root of unity (ref: number_theory.cu
    try_minimal_primitive_root) — matches SEAL's choice so twiddle tables are
    reproducible across implementations."""
    key = (degree, modulus)
    if key in _min_root_cache:
        return _min_root_cache[key]
    root = try_primitive_root(degree, modulus)
    if root is None:
        _min_root_cache[key] = None
        return None
    generator_sq = root * root % modulus
    current = root
    best = root
    # All primitive degree-th roots are root^(odd); step through them.
    for _ in range(degree // 2 - 1):
        current = current * generator_sq % modulus
        if current < best:
            best = current
    _min_root_cache[key] = best
    return best


def reverse_bits(value: int, bit_count: int) -> int:
    """Bit reversal of the low bit_count bits (ref: basics.h:121-147)."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


def naf(value: int) -> list[int]:
    """Non-adjacent form of value as signed powers of two, lowest first: the
    rotation-step decomposition (ref: number_theory.cu naf,
    evaluator_keyswitching.cu:276)."""
    out = []
    while value != 0:
        if value & 1:
            z = 2 - (value % 4)
            out.append(z)
            value -= z
        else:
            out.append(0)
        value //= 2
    return [d << i for i, d in enumerate(out) if d != 0]
