"""Key generation (counterpart of troy_tpu/core/keygen.py).

Ternary secret key (NTT form, key level), the public key (an NTT-form
symmetric encryption of zero at the key level), and switching keys with the
single-special-prime layout: key i of the (decomp, 2, L_key, n) switching
key is Enc_s(0) + (q_special mod q_i) * target in RNS limb i only.  The
targets are s^k (relinearization keys), s(x^g) (Galois keys) or another
secret (keyswitching keys).

Randomness comes from a torch.Generator or a RandomGenerator (prng=; its
"threefry" and "aes" modes draw the JAX package's bits), in the JAX package's order: the
secret key's ternary polynomial, then per switching key a (decomp, L_key, n)
then e (decomp, n), times t for BGV.  With neither, the context's seed
gives RandomGenerator(context.seed, "threefry", domain="keygen"), the JAX
package's default stream (a fresh seed when the context has none).
"""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .keys import SecretKey, PublicKey, KSwitchKeys, RelinKeys, GaloisKeys
from .ciphertext import Ciphertext
from .rlwe import encrypt_zero_symmetric, _noise
from ..ops import poly as P, rp as R
from ..ops.galois import GaloisTool
from ..utils.random import RandomGenerator, sample_uniform, sample_ternary, stream, new_seed


class KeyGenerator:
    def __init__(self, context: HeContext, generator: torch.Generator | None = None,
                 sk: SecretKey | None = None, prng: RandomGenerator | None = None):
        self.context = context
        self.generator = stream(context.seed, generator, prng, "keygen")
        self.prng = self.generator  # the JAX package's name for the stream
        cd = context.key_context_data()
        if sk is None:
            qtab = cd.qtab()
            s = sample_ternary((cd.parms.poly_modulus_degree,), qtab, self.generator)
            sk = SecretKey(R.ntt_forward(s, qtab), cd.parms_id)
        self._sk = sk
        self._sk_powers: dict[int, torch.Tensor] = {1: sk.data}

    @property
    def secret_key(self) -> SecretKey:
        return self._sk

    def secret_key_power(self, k: int) -> torch.Tensor:
        """s^k in NTT form at key level (cached)."""
        if k not in self._sk_powers:
            qtab = self.context.key_context_data().qtab()
            self._sk_powers[k] = R.dyadic_product(
                self.secret_key_power(k - 1), self._sk.data, qtab)
        return self._sk_powers[k]

    def create_public_key(self, save_seed: bool = False) -> PublicKey:
        """With save_seed, the key's c1 is regenerated from a seed it keeps,
        so that it serializes as (c0, seed)."""
        cd = self.context.key_context_data()
        seed = new_seed(self.generator) if save_seed else None
        data = encrypt_zero_symmetric(cd, self._sk.data, self.generator, ntt_form=True,
                                      seed=seed)
        return PublicKey(Ciphertext(data, cd.parms_id, is_ntt_form=True, seed=seed))

    def _generate_one_kswitch_key(self, target_ntt: torch.Tensor) -> torch.Tensor:
        cd = self.context.key_context_data()
        if not self.context.using_keyswitching:
            raise ValueError("[KeyGenerator] context has no special prime")
        qtab = cd.qtab()
        n = cd.parms.poly_modulus_degree
        decomp = cd.coeff_modulus_size - 1
        a = sample_uniform((decomp, cd.coeff_modulus_size, n), qtab, self.generator)
        e = _noise(cd, (decomp, n), qtab, self.generator)
        return self._kswitch_combine(cd, target_ntt, a, e, self._sk.data)

    @staticmethod
    def _kswitch_combine(cd: ContextData, target_ntt, a, e, s) -> torch.Tensor:
        """Switching-key assembly from given a (NTT form) and e (coefficient
        form): (decomp, 2, L_key, n)."""
        qtab = cd.qtab()
        L_key = cd.coeff_modulus_size
        decomp = L_key - 1
        q_sp = cd.parms.coeff_modulus[-1].value
        c0 = P.negate(P.add(R.dyadic_product(a, s[None], qtab),
                            R.ntt_forward(e, qtab), qtab), qtab)
        # add (q_sp mod q_i) * target at limb i of key i only
        factor = torch.tensor([q_sp % m.value for m in cd.parms.coeff_modulus],
                              dtype=torch.int64, device=cd.device).view(-1, 1)
        term = R.mul_mod(target_ntt, factor, qtab)
        mask = torch.eye(decomp, L_key, dtype=torch.bool, device=cd.device)[:, :, None]
        c0 = torch.where(mask, P.add(c0, term[None], qtab), c0)
        return torch.stack([c0, a], dim=1)

    def create_relin_keys(self, max_power: int = 2) -> RelinKeys:
        """Switching keys for s^2 .. s^max_power."""
        keys = {p - 2: self._generate_one_kswitch_key(self.secret_key_power(p))
                for p in range(2, max_power + 1)}
        return RelinKeys(keys, self.context.key_parms_id)

    def create_galois_keys_from_elements(self, elements: list[int]) -> GaloisKeys:
        """Keys for x -> x^g, g in elements (ref: key_generator.h:79-92)."""
        tool = GaloisTool.for_context(self.context.key_context_data())
        keys = {g: self._generate_one_kswitch_key(tool.apply_ntt(self._sk.data, g))
                for g in elements}
        return GaloisKeys(keys, self.context.key_parms_id)

    def create_galois_keys_from_steps(self, steps: list[int]) -> GaloisKeys:
        n = self.context.key_context_data().parms.poly_modulus_degree
        return self.create_galois_keys_from_elements(
            sorted({GaloisTool.get_element_from_step(s, n) for s in steps}))

    def create_galois_keys(self, include_conjugate: bool = True) -> GaloisKeys:
        """Rotation steps +-1, +-2, +-4, ... below n/2, plus conjugation:
        the default set (ref: galois.h get_elements_all)."""
        n = self.context.key_context_data().parms.poly_modulus_degree
        steps: list[int] = []
        step = 1
        while step < n // 2:
            steps += [step, -step]
            step *= 2
        elems = {GaloisTool.get_element_from_step(s, n) for s in steps}
        if include_conjugate:
            elems.add(GaloisTool.conjugate_element(n))
        return self.create_galois_keys_from_elements(sorted(elems))

    def create_automorphism_keys(self) -> GaloisKeys:
        """Keys for the LWE packing tree and field trace: the elements
        2^j + 1, 1 <= j <= log2 n, drawn in that order."""
        n = self.context.key_context_data().parms.poly_modulus_degree
        return self.create_galois_keys_from_elements(
            [(1 << j) + 1 for j in range(1, n.bit_length())])

    def create_keyswitching_key(self, new_key: SecretKey) -> KSwitchKeys:
        """Key that switches ciphertexts under this generator's secret to
        new_key: made by new_key's holder over the old secret (ref:
        key_generator.cu:159)."""
        gen_new = KeyGenerator(self.context, self.generator, sk=new_key)
        return KSwitchKeys({0: gen_new._generate_one_kswitch_key(self._sk.data)},
                           self.context.key_parms_id)
