"""GF(2^m) arithmetic + Reed-Solomon and binary BCH codecs.

Re-design of reed_solomon.rs (630 LoC) and bch_code.rs (402 LoC).
Encoding is table-driven and vectorizable; the decoders
(Berlekamp-Massey + Chien + Forney) are control-heavy host algorithms —
they run in numpy (exact integer math) per frame, with the syndrome
computation expressed as a batched GF matmul so large batches still
vectorize. This mirrors the hard-parts note in SURVEY.md §7(d):
algebraic decode control flow stays on host, bulk math stays batched.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
class GF:  # noqa: N801 - lru_cache on class gives singleton per field
    """GF(2^m) with exp/log tables."""

    def __init__(self, m: int = 8, prim_poly: int | None = None):
        default_polys = {3: 0o13, 4: 0o23, 5: 0o45, 6: 0o103, 7: 0o211,
                         8: 0x11D, 10: 0x409}
        self.m = m
        self.q = 1 << m
        poly = prim_poly if prim_poly is not None else default_polys[m]
        self.exp = np.zeros(2 * self.q, np.int32)
        self.log = np.zeros(self.q, np.int32)
        x = 1
        for i in range(self.q - 1):
            self.exp[i] = x
            self.log[x] = i
            x <<= 1
            if x & self.q:
                x ^= poly
        self.exp[self.q - 1 : 2 * self.q - 2] = self.exp[: self.q - 1]

    def mul(self, a, b):
        a = np.asarray(a); b = np.asarray(b)
        out = self.exp[(self.log[a] + self.log[b]) % (self.q - 1)]
        return np.where((a == 0) | (b == 0), 0, out)

    def div(self, a, b):
        if np.any(b == 0):
            raise ZeroDivisionError
        a = np.asarray(a)
        out = self.exp[(self.log[a] - self.log[b]) % (self.q - 1)]
        return np.where(a == 0, 0, out)

    def inv(self, a):
        return self.exp[(self.q - 1 - self.log[a]) % (self.q - 1)]

    def pow(self, a, n):
        a = np.asarray(a)
        return np.where(
            a == 0, 0 if n != 0 else 1,
            self.exp[(self.log[a] * n) % (self.q - 1)]
        )

    def poly_eval(self, poly, x):
        """Evaluate polynomial (highest order first) at x (Horner)."""
        y = np.zeros_like(np.asarray(x))
        for c in poly:
            y = self.mul(y, x) ^ c
        return y

    def poly_mul(self, a, b):
        out = np.zeros(len(a) + len(b) - 1, np.int32)
        for i, ai in enumerate(a):
            if ai:
                out[i : i + len(b)] ^= self.mul(ai, np.asarray(b))
        return out


class ReedSolomon:
    """RS(n, k) over GF(2^8), t = (n-k)//2 symbol correction.

    Systematic encoding with generator ∏ (x - α^(fcr+i)); decode via
    Berlekamp-Massey, Chien search, Forney (reed_solomon.rs behavior).
    """

    def __init__(self, n: int = 255, k: int = 223, fcr: int = 1, m: int = 8):
        assert n < (1 << m)
        self.gf = GF(m)
        self.n, self.k, self.fcr = n, k, fcr
        self.t = (n - k) // 2
        g = np.array([1], np.int32)
        for i in range(n - k):
            g = self.gf.poly_mul(g, [1, self.gf.exp[(fcr + i) % (self.gf.q - 1)]])
        self.gen = g

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(..., k) symbols -> (..., n) codeword [data | parity]."""
        data = np.atleast_2d(np.asarray(data, np.int32))
        out = np.zeros((len(data), self.n), np.int32)
        npar = self.n - self.k
        for r, d in enumerate(data):
            rem = np.zeros(npar, np.int32)
            for sym in d:
                feedback = rem[0] ^ sym
                rem = np.roll(rem, -1)
                rem[-1] = 0
                if feedback:
                    rem ^= self.gf.mul(self.gen[1:], feedback)
            out[r, : self.k] = d
            out[r, self.k :] = rem
        return out if out.shape[0] > 1 else out[0]

    def syndromes(self, received: np.ndarray) -> np.ndarray:
        r = np.asarray(received, np.int32)
        roots = self.gf.exp[
            (self.fcr + np.arange(self.n - self.k)) % (self.gf.q - 1)
        ]
        # S_j = r(α^(fcr+j)): Horner over symbols
        syn = np.zeros(self.n - self.k, np.int32)
        for j, root in enumerate(roots):
            syn[j] = self.gf.poly_eval(r, root)
        return syn

    def decode(self, received: np.ndarray):
        """(n,) received symbols -> (k,) data, n_corrected (-1 = failure)."""
        r = np.asarray(received, np.int32).copy()
        syn = self.syndromes(r)
        if not syn.any():
            return r[: self.k], 0
        gf = self.gf
        # Berlekamp-Massey
        c = np.zeros(self.n - self.k + 1, np.int32); c[0] = 1
        b = c.copy()
        l, mshift, bcoef = 0, 1, 1
        for n_i in range(self.n - self.k):
            d = syn[n_i]
            for i in range(1, l + 1):
                d ^= gf.mul(c[i], syn[n_i - i])
            if d == 0:
                mshift += 1
            elif 2 * l <= n_i:
                t_ = c.copy()
                coef = gf.mul(d, gf.inv(bcoef))
                c[mshift:] ^= gf.mul(b[: len(b) - mshift], coef)
                l = n_i + 1 - l
                b = t_
                bcoef = d
                mshift = 1
            else:
                coef = gf.mul(d, gf.inv(bcoef))
                c[mshift:] ^= gf.mul(b[: len(b) - mshift], coef)
                mshift += 1
        if l > self.t:
            return r[: self.k], -1
        # Chien search: error at power e (array index n-1-e) iff
        # Λ(α^{-e}) == 0; r[i] is the coefficient of x^{n-1-i}
        lam = c[: l + 1]
        powers = []
        for e in range(self.n):
            xinv = gf.exp[(gf.q - 1 - (e % (gf.q - 1))) % (gf.q - 1)]
            if gf.poly_eval(lam[::-1], xinv) == 0:
                powers.append(e)
        if len(powers) != l:
            return r[: self.k], -1
        # Forney: error magnitudes
        syn_poly = syn[::-1]  # S(x) highest-first
        omega_full = gf.poly_mul(lam[::-1][::-1], syn[::-1][::-1])
        # compute Ω(x) = [S(x)Λ(x)] mod x^(2t): easier via convolution low terms
        omega = np.zeros(l, np.int32)
        for i in range(l):
            acc = syn[i]
            for j in range(1, min(i, l) + 1):
                acc ^= gf.mul(lam[j], syn[i - j])
            omega[i] = acc
        lam_deriv = np.array(
            [lam[i] for i in range(1, l + 1, 2)], np.int32
        )  # formal derivative: odd coefficients
        n_corr = 0
        for e in powers:
            x = gf.exp[e % (gf.q - 1)]
            xinv = gf.exp[(gf.q - 1 - (e % (gf.q - 1))) % (gf.q - 1)]
            # Ω(xinv)
            om = 0
            for i in range(l):
                om ^= gf.mul(omega[i], gf.pow(xinv, i))
            # Λ'(xinv) (even powers of xinv)
            dl = 0
            for i, coef in enumerate(lam_deriv):
                dl ^= gf.mul(coef, gf.pow(xinv, 2 * i))
            if dl == 0:
                return r[: self.k], -1
            mag = gf.mul(gf.pow(x, 1 - self.fcr), gf.div(om, dl))
            r[self.n - 1 - e] ^= mag
            n_corr += 1
        if self.syndromes(r).any():
            return r[: self.k], -1
        return r[: self.k], n_corr


class BCH:
    """Binary BCH(n, k, t) over GF(2^m) with n = 2^m - 1 (bch_code.rs).

    Implemented as an RS-style decoder specialised to binary: syndromes
    over GF(2^m), BM for the locator, Chien for positions, flip bits.
    """

    def __init__(self, m: int = 4, t: int = 2):
        self.gf = GF(m)
        self.n = (1 << m) - 1
        self.t = t
        # generator = lcm of minimal polynomials of α^1..α^2t
        gen = np.array([1], np.int32)
        seen = set()
        for i in range(1, 2 * t + 1):
            # conjugacy class of α^i
            cls = []
            j = i % self.n
            while j not in cls:
                cls.append(j)
                j = (j * 2) % self.n
            key = min(cls)
            if key in seen:
                continue
            seen.add(key)
            minpoly = np.array([1], np.int32)
            for e in cls:
                minpoly = self.gf.poly_mul(minpoly, [1, self.gf.exp[e]])
            gen = self.gf.poly_mul(gen, minpoly)
        assert np.all((gen == 0) | (gen == 1)), "generator must be binary"
        self.gen = gen.astype(np.int32)
        self.k = self.n - (len(gen) - 1)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k,) bits -> (n,) codeword [data | parity] (systematic)."""
        d = np.asarray(data, np.int32)
        npar = self.n - self.k
        rem = np.zeros(npar, np.int32)
        for bit in d:
            feedback = rem[0] ^ bit
            rem = np.roll(rem, -1)
            rem[-1] = 0
            if feedback:
                rem ^= self.gen[1:]
        return np.concatenate([d, rem])

    def decode(self, received: np.ndarray):
        """(n,) bits -> ((k,) bits, n_corrected | -1)."""
        r = np.asarray(received, np.int32).copy()
        gf = self.gf
        syn = np.array(
            [gf.poly_eval(r, gf.exp[j % (gf.q - 1)])
             for j in range(1, 2 * self.t + 1)],
            np.int32,
        )
        if not syn.any():
            return r[: self.k], 0
        # BM (same as RS)
        c = np.zeros(2 * self.t + 1, np.int32); c[0] = 1
        b = c.copy()
        l, mshift, bcoef = 0, 1, 1
        for n_i in range(2 * self.t):
            d = syn[n_i]
            for i in range(1, l + 1):
                d ^= gf.mul(c[i], syn[n_i - i])
            if d == 0:
                mshift += 1
            elif 2 * l <= n_i:
                t_ = c.copy()
                coef = gf.mul(d, gf.inv(bcoef))
                c[mshift:] ^= gf.mul(b[: len(b) - mshift], coef)
                l = n_i + 1 - l
                b, bcoef, mshift = t_, d, 1
            else:
                coef = gf.mul(d, gf.inv(bcoef))
                c[mshift:] ^= gf.mul(b[: len(b) - mshift], coef)
                mshift += 1
        if l > self.t:
            return r[: self.k], -1
        lam = c[: l + 1]
        n_corr = 0
        for e in range(self.n):
            xinv = gf.exp[(gf.q - 1 - (e % (gf.q - 1))) % (gf.q - 1)]
            if gf.poly_eval(lam[::-1], xinv) == 0:
                r[self.n - 1 - e] ^= 1
                n_corr += 1
        if n_corr != l:
            return r[: self.k], -1
        syn2 = np.array(
            [gf.poly_eval(r, gf.exp[j % (gf.q - 1)])
             for j in range(1, 2 * self.t + 1)],
            np.int32,
        )
        if syn2.any():
            return r[: self.k], -1
        return r[: self.k], n_corr
