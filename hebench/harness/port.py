"""The system under test: troy_tpu_torch's batched evaluator at the first
data level of a configuration.  Each operation's file under ops/ builds
its timed step from a Port (its context, evaluator and batched evaluator)
and the switching keys the benchmark made (scheme.Keys).

The NTT route is the traffic's `ntt_backend` (the port's set_ntt_backend,
which the tables built after it carry), the port's default route, K1, where
the traffic names none, whatever TROY_NTT_BACKEND says.
"""

from __future__ import annotations

from .scheme import Config

DEFAULT_NTT_BACKEND = "sixstep"


class Port:
    def __init__(self, cfg: Config, device, ntt_backend: str = DEFAULT_NTT_BACKEND):
        from troy_tpu_torch.core.coeff_modulus import SecurityLevel
        from troy_tpu_torch.core.context import HeContext
        from troy_tpu_torch.core.evaluator import Evaluator
        from troy_tpu_torch.core.modulus import Modulus
        from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
        from troy_tpu_torch.ops import ntt
        from troy_tpu_torch.parallel.batched import BatchedEvaluator

        parms = EncryptionParameters(SchemeType[cfg.scheme])
        parms.set_poly_modulus_degree(cfg.n)
        parms.set_coeff_modulus([Modulus(p) for p in cfg.primes])
        if cfg.plain_modulus:
            parms.set_plain_modulus(cfg.plain_modulus)
        level = SecurityLevel[cfg.raw.get("security_level", "Classical128")]
        ntt.set_ntt_backend(ntt_backend)
        self.context = HeContext.create(parms, True, level, None, device=device)
        self.evaluator = Evaluator(self.context, lift=cfg.lift)
        self.batched = BatchedEvaluator(self.evaluator, self.context.first_context_data())
