"""Data-driven learners: GMM, LBG, PCA, ICA, NMF (counterpart of
``diffsptk_tpu/ops/learners.py``).

Each learner's inner step (the E-step posteriors, the Lloyd assignment,
the multiplicative update) is plain torch on the learner's device; the
convergence loop runs on the host, as the JAX package's does, and reads
one scalar back from the device per iteration to decide whether to go on.
Those reads are the learners' stated host steps (each class' docstring
counts them); the steps themselves read nothing back.  ``batch_size=``
chunks a large array (or the input may already be an iterable of arrays),
and every reduction over the data is a sum of per-chunk statistics, equal
to the full-batch result up to the order of summation.

Random draws come from JAX's generator, drawn on the learner's device
(``kernels/threefry.py``, whose twin is ``utils/prng.py``), so a seed
gives the JAX package's initial means, codebooks and factors (its uniform
factors and float32 normals bit for bit, its float64 normals to rtol 1e-10:
ROADMAP C.13).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import BaseLearnerOp, resolve_device
from ..kernels import threefry
from ..utils import prng
from .vq import VectorQuantization, initial_codebook


def as_chunks(x, batch_size, device=None, dtype=None):
    """Learner input as a list of 2-D tensor chunks on ``device`` in
    ``dtype`` (each kept where not given).

    ``x`` may be one tensor or numpy array (cut into ``batch_size`` rows
    where given), or any iterable of them (data that arrives in pieces).
    """
    def tensor(c):
        return torch.as_tensor(c, device=device, dtype=dtype)

    if isinstance(x, (torch.Tensor, np.ndarray)):
        x = tensor(x)
        if batch_size is None:
            return [x]
        return [x[i:i + batch_size] for i in range(0, x.shape[0],
                                                   batch_size)]
    chunks = [tensor(c) for c in x]
    if not chunks:
        raise ValueError("Input data is empty.")
    return chunks


# rows a GEMM sums at once in the GMM's statistics: a float32 GEMM on the
# card accumulates each entry along its reduction in one run, whose
# rounding grows with the run's length (ROADMAP C.19)
STAT_ROWS = 1024


def row_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b`` as per-block GEMMs over ``STAT_ROWS`` rows at a time
    and a sum of the blocks' results: equal up to the order of sums, with
    the rounding of blocks of rows instead of all of them."""
    B = a.shape[0]
    full = B - B % STAT_ROWS
    if full <= STAT_ROWS:
        return a.T @ b
    n = full // STAT_ROWS
    out = torch.sum(a[:full].reshape(n, STAT_ROWS, -1).transpose(1, 2)
                    @ b[:full].reshape(n, STAT_ROWS, -1), dim=0)
    return out + a[full:].T @ b[full:] if full < B else out


def cluster_sums(indices: torch.Tensor, x: torch.Tensor, K: int):
    """Per-cluster counts (int64, exact) and sums of the rows of ``x``
    assigned by ``indices``: the counts by an integer ``index_add_``, the
    sums as one one-hot GEMM, whose order of summation is fixed, where the
    card's float ``index_add_`` adds with atomics in an order that changes
    from run to run."""
    counts = torch.zeros(K, dtype=torch.int64, device=x.device).index_add_(
        0, indices, torch.ones_like(indices))
    onehot = (indices[:, None] == torch.arange(K, device=x.device)).to(
        x.dtype)
    return counts, onehot.T @ x


class LocalRows:
    """The data-parallel reductions of the EM and Lloyd loops, of one
    process that holds all the rows: the number of rows, the sums of
    statistics over the processes that hold rows, and the one host read of
    a step.  ``parallel/learners.py``'s ``MeshRows`` spreads the rows over
    a mesh axis."""

    def rows(self, chunks) -> int:
        return sum(c.shape[0] for c in chunks)

    def sum(self, *stats) -> tuple:
        return stats

    def read(self, *scalars) -> list:
        return torch.stack(scalars).tolist()


class GaussianMixtureModeling(BaseLearnerOp):
    """EM for a Gaussian mixture with diagonal, full or block covariance
    and UBM-MAP smoothing.

    Host steps: one scalar (the log-likelihood) read back per EM
    iteration, for the convergence test.  The E-step and the M-step read
    nothing; the full covariance's Cholesky factor is ``cholesky_ex``'s,
    which checks nothing on the host.
    """

    def __init__(self, order: int, n_mixture: int, *, n_iter: int = 100,
                 eps: float = 1e-5, weight_floor: float = 1e-5,
                 var_floor: float = 1e-6, var_type: str = "diag",
                 block_size=None, ubm=None, alpha: float = 0,
                 batch_size=None, verbose=False, seed: int = 0,
                 dtype=None, device=None, reducer=None) -> None:
        super().__init__()
        if order < 0:
            raise ValueError("order must be non-negative.")
        if n_mixture <= 0:
            raise ValueError("n_mixture must be positive.")
        if n_iter <= 0:
            raise ValueError("n_iter must be positive.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")
        if not 0 <= weight_floor <= 1 / n_mixture:
            raise ValueError("weight_floor must be in [0, 1 / K].")
        if var_floor < 0:
            raise ValueError("var_floor must be non-negative.")
        if not 0 <= alpha <= 1:
            raise ValueError("alpha must be in [0, 1].")
        if alpha != 0 and ubm is None:
            raise ValueError("ubm must be provided when alpha is not 0.")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.order = order
        self.n_mixture = n_mixture
        self.n_iter = n_iter
        self.eps = eps
        self.weight_floor = weight_floor
        self.var_floor = var_floor
        self.alpha = alpha
        self.batch_size = batch_size
        self.reducer = LocalRows() if reducer is None else reducer

        L = order + 1
        if block_size is None:
            block_size = [L]
        block_size = list(block_size)
        if sum(block_size) != L:
            raise ValueError("The sum of block_size must be order + 1.")
        if not all(0 < b for b in block_size):
            raise ValueError("All elements of block_size must be positive.")
        self.is_diag = var_type == "diag" and len(block_size) == 1

        mask = np.zeros((L, L))
        cumsum = np.cumsum(np.insert(block_size, 0, 0))
        for b1, s1, e1 in zip(block_size, cumsum[:-1], cumsum[1:]):
            if var_type == "diag":
                for b2, s2, e2 in zip(block_size, cumsum[:-1], cumsum[1:]):
                    if b1 == b2:
                        mask[s1:e1, s2:e2] = np.eye(b1)
            elif var_type == "full":
                mask[s1:e1, s1:e1] = 1
            else:
                raise ValueError(f"var_type {var_type} is not supported.")
        dtype = dtype or torch.get_default_dtype()
        dev = resolve_device(device)
        K = n_mixture
        self.register_buffer("mask", torch.as_tensor(mask, dtype=dtype,
                                                     device=dev))
        self.register_buffer("w", torch.ones(K, dtype=dtype, device=dev) / K)
        self.register_buffer("mu", initial_codebook(seed, (K, L), dtype,
                                                    dev))
        self.register_buffer("sigma", torch.eye(
            L, dtype=dtype, device=dev).repeat(K, 1, 1))
        if ubm is not None:
            self.set_params(ubm)
            for name, value in zip(("ubm_w", "ubm_mu", "ubm_sigma"), ubm):
                self.register_buffer(name, self._like(value, self.w))

    @staticmethod
    def _like(value, ref: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, dtype=ref.dtype,
            device=ref.device)

    def set_params(self, params) -> None:
        w, mu, sigma = params
        if w is not None:
            self.w = self._like(w, self.w)
        if mu is not None:
            self.mu = self._like(mu, self.mu)
        if sigma is not None:
            self.sigma = self._like(sigma, self.sigma)

    def _chunks(self, x):
        return as_chunks(x, self.batch_size, self.w.device, self.w.dtype)

    @torch.no_grad()
    def warmup(self, x, **lbg_params) -> None:
        """Initialize the mean vectors by LBG clustering (its host steps
        are the LBG's)."""
        chunks = self._chunks(x)
        lbg_params.setdefault("batch_size", self.batch_size)
        lbg = LindeBuzoGrayAlgorithm(self.order, self.n_mixture,
                                     dtype=self.w.dtype,
                                     device=self.w.device,
                                     reducer=self.reducer, **lbg_params)
        codebook, indices, _ = lbg(chunks, return_indices=True)
        K = codebook.shape[0]
        counts = var = 0
        t1 = 0
        for c in chunks:
            t2 = t1 + c.shape[0]
            idx = indices[t1:t2]
            n, v = cluster_sums(idx, (c - codebook[idx]) ** 2, K)
            counts, var = counts + n, var + v
            t1 = t2
        counts, var = self.reducer.sum(counts, var)
        counts = counts.to(codebook.dtype)
        self.w = counts / torch.sum(counts)     # every process's rows
        self.mu = codebook
        self.sigma = torch.diag_embed(
            var / torch.clamp(counts, min=1)[:, None]) * self.mask

    def _e_step(self, x, reduction: str = "sum", in_order=None,
                params=None):
        w, mu_full, sigma_full = (params if params is not None
                                  else (self.w, self.mu, self.sigma))
        if in_order is None:
            L = self.order + 1
            mu, sigma = mu_full, sigma_full
        else:
            L = in_order + 1
            mu, sigma = mu_full[:, :L], sigma_full[:, :L, :L]
        log_pi = L * math.log(2 * math.pi)
        diff = x[:, None, :] - mu[None, :, :]
        if self.is_diag:
            diag = torch.diagonal(sigma, dim1=-2, dim2=-1)
            log_det = torch.sum(torch.log(diag), dim=-1)
            mahala = torch.sum(diff * diff / diag, dim=-1)
        else:
            col = torch.linalg.cholesky_ex(sigma).L
            log_det = 2 * torch.sum(
                torch.log(torch.diagonal(col, dim1=-2, dim2=-1)), dim=-1)
            # ||col^-1 diff||^2 by one triangular solve per component
            z = torch.linalg.solve_triangular(
                col, torch.movedim(diff, 0, -1), upper=False)  # (K, L, B)
            mahala = torch.movedim(torch.sum(z * z, dim=-2), -1, 0)
        numer = torch.log(w) - 0.5 * (log_pi + log_det + mahala)
        denom = torch.logsumexp(numer, dim=-1, keepdim=True)
        posterior = torch.exp(numer - denom)
        if reduction == "none":
            ll = denom[..., 0]
        elif reduction == "sum":
            ll = torch.sum(denom)
        else:
            raise ValueError(f"reduction {reduction} is not supported.")
        return posterior, ll

    def _accum_stats(self, params, x):
        """Per-chunk sufficient statistics (sum g, sum g x, sum g x x^T,
        ll).  The full second moment is a GEMM over (B, K L) rows, in
        blocks of rows (``row_sums``)."""
        posterior, ll = self._e_step(x, params=params)
        z = torch.sum(posterior, dim=0)
        px = row_sums(posterior, x)
        if self.is_diag:
            pxx = row_sums(posterior, x * x)
        else:
            B, K = posterior.shape
            L = x.shape[-1]
            pxx = row_sums((posterior[:, :, None] * x[:, None, :]).reshape(
                B, K * L), x).reshape(K, L, L)
        return z, px, pxx, ll

    def _m_step(self, stats, T: float):
        """Closed-form M-step from accumulated statistics."""
        y, px, pxx, ll = stats
        if self.alpha == 0:
            z = y
            w = z / T
        else:
            xi = self.ubm_w * self.alpha
            z = y + xi
            w = z / (T + self.alpha)
        zinv = 1.0 / z
        w = torch.clamp(w, min=self.weight_floor)
        sum_floor = self.weight_floor * self.n_mixture
        a = (1 - sum_floor) / (torch.sum(w) - sum_floor)
        b = self.weight_floor * (1 - a)
        w = a * w + b

        if self.alpha == 0:
            mu = px * zinv[:, None]
        else:
            mu = (px + xi[:, None] * self.ubm_mu) * zinv[:, None]

        def finite(t):
            return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)

        if self.is_diag:
            mm = mu ** 2
            if self.alpha == 0:
                sig = pxx * zinv[:, None] - mm
            else:
                nu = px / y[:, None]
                nm = nu * mu
                aa = finite(pxx - y[:, None] * (2 * nm - mm))
                bb = xi[:, None] * torch.diagonal(self.ubm_sigma, dim1=-2,
                                                  dim2=-1)
                cc = xi[:, None] * (self.ubm_mu - mu) ** 2
                sig = (aa + bb + cc) * zinv[:, None]
            sigma = torch.diag_embed(torch.clamp(sig, min=self.var_floor))
        else:
            mm = mu[:, :, None] * mu[:, None, :]
            if self.alpha == 0:
                sig = pxx * zinv[:, None, None] - mm
            else:
                nu = px / y[:, None]
                nm = nu[:, :, None] * mu[:, None, :]
                aa = finite(pxx - y[:, None, None]
                            * (nm + nm.transpose(-2, -1) - mm))
                bb = xi[:, None, None] * self.ubm_sigma
                dm = self.ubm_mu - mu
                cc = xi[:, None, None] * (dm[:, :, None] * dm[:, None, :])
                sig = (aa + bb + cc) * zinv[:, None, None]
            sig = sig * self.mask
            d = torch.clamp(torch.diagonal(sig, dim1=-2, dim2=-1),
                            min=self.var_floor)
            L = sig.shape[-1]
            eye = torch.eye(L, dtype=torch.bool, device=sig.device)
            sigma = torch.where(eye, torch.diag_embed(d), sig)
        return (w, mu, sigma), ll

    @torch.no_grad()
    def forward(self, x, return_posterior: bool = False, callback=None):
        """Fit by EM.  ``callback(iteration=, log_likelihood=, change=,
        params=)`` runs once per iteration; returning False stops the loop.
        The fit continues from the current parameters, so a stopped run
        resumes by reloading them (``set_params``) and calling again."""
        chunks = self._chunks(x)
        T = float(self.reducer.rows(chunks))
        params = (self.w, self.mu, self.sigma)
        prev_ll = -np.inf
        ll = torch.tensor(-np.inf)
        for n in range(self.n_iter):
            stats = self._accum_stats(params, chunks[0])
            for c in chunks[1:]:
                stats = tuple(a + b for a, b in zip(
                    stats, self._accum_stats(params, c)))
            new_params, ll = self._m_step(self.reducer.sum(*stats), T)
            ll_host, = self.reducer.read(ll)        # the stated host read
            change = ll_host - prev_ll
            # ll is evaluated at the pre-update parameters, as the JAX
            # package keeps the reference's bookkeeping
            params = new_params
            if callback is not None and callback(
                    iteration=n, log_likelihood=ll_host / T,
                    change=change, params=params) is False:
                break
            if n and change < self.eps:
                break
            prev_ll = ll_host
        self.w, self.mu, self.sigma = params
        params = (self.w, self.mu, self.sigma)
        if return_posterior:
            posterior = torch.cat([self._e_step(c)[0] for c in chunks],
                                  dim=0)
            return params, posterior, ll
        return params, ll

    def transform(self, x):
        """Posterior class, log-probability and, where ``x`` holds the
        first part of the joint vectors, the regression of the rest."""
        N = x.shape[-1] - 1
        posterior, log_prob = self._e_step(x, reduction="none", in_order=N)
        indices = torch.argmax(posterior, dim=-1)
        if self.order == N:
            return None, indices, log_prob
        L = N + 1
        sigma_yx = self.sigma[:, L:, :L]
        sigma_xx = self.sigma[:, :L, :L]
        # sigma_yx sigma_xx^-1 without forming the inverse (SPD sigma_xx)
        syx = torch.linalg.solve_ex(
            sigma_xx, sigma_yx.transpose(-2, -1)).result.transpose(-2, -1)
        mu_x = self.mu[indices, :L]
        mu_y = self.mu[indices, L:]
        diff = (x - mu_x)[..., None]
        E = mu_y + (syx[indices] @ diff)[..., 0]
        return E, indices, log_prob


class LindeBuzoGrayAlgorithm(BaseLearnerOp):
    """Codebook training by binary splitting and Lloyd iterations.

    Host steps: per Lloyd iteration one read of two scalars (the mean
    distance and the number of clusters below ``min_data_per_cluster``);
    an iteration that finds such clusters reads two more (the fullest
    cluster's index and the indices of the starved ones).  Counts are
    integers and the centroid sums a one-hot GEMM (``cluster_sums``), so
    two runs on the card take the same decisions.
    """

    def __init__(self, order: int, codebook_size: int, *,
                 min_data_per_cluster: int = 1, n_iter: int = 100,
                 eps: float = 1e-10, perturb_factor: float = 1e-5,
                 init="mean", metric: str = "none", batch_size=None,
                 seed: int = 0, verbose=False, dtype=None,
                 device=None, reducer=None) -> None:
        super().__init__()
        if codebook_size <= 0:
            raise ValueError("codebook_size must be positive.")
        if min_data_per_cluster <= 0:
            raise ValueError("min_data_per_cluster must be positive.")
        if n_iter <= 0:
            raise ValueError("n_iter must be positive.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")
        if perturb_factor <= 0:
            raise ValueError("perturb_factor must be positive.")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.order = order
        self.codebook_size = codebook_size
        self.min_data_per_cluster = min_data_per_cluster
        self.n_iter = n_iter
        self.eps = eps
        self.perturb_factor = perturb_factor
        self.metric = metric
        self.batch_size = batch_size
        self.reducer = LocalRows() if reducer is None else reducer
        self.vq = VectorQuantization(order, codebook_size, seed=seed,
                                     dtype=dtype, device=device)
        # the key lives on the codebook's device: a draw copies nothing
        self.register_buffer("key", prng.PRNGKey(
            seed, device=self.vq.codebook.device))
        if isinstance(init, (np.ndarray, torch.Tensor)):
            given = init.shape[0]
            c = codebook_size
            while c % 2 == 0 and c != given:
                c //= 2
            if c != given:
                raise ValueError(
                    "Codebook size must be a power-of-two multiple of the "
                    "initial codebook size.")
            self.curr_codebook_size = given
            self.init = "none"
            with torch.no_grad():
                self.vq.codebook[:given] = torch.as_tensor(init)
        else:
            c = codebook_size
            while c % 2 == 0:
                c //= 2
            self.curr_codebook_size = c
            self.init = init

    def _rand(self, shape, dtype):
        self.key, sub = prng.split(self.key)
        return prng.normal(sub, shape, dtype)

    @torch.no_grad()
    def forward(self, x, return_indices: bool = False, callback=None):
        cb = self.vq.codebook
        chunks = as_chunks(x, self.batch_size, cb.device, cb.dtype)
        if chunks[0].ndim != 2:
            raise ValueError("Input vectors must be 2D.")
        T = self.reducer.rows(chunks)
        L = chunks[0].shape[1]

        if self.init == "mean":
            cb[0] = self.reducer.sum(
                sum(torch.sum(c, dim=0) for c in chunks))[0] / T
        elif self.init != "none":
            raise ValueError(f"init {self.init} is not supported.")
        cb[self.curr_codebook_size:] = 1e10

        def e_step(K=None):
            """Assignment pass: per-chunk indices, the summed squared
            distance and, where K is given, per-cluster counts and
            centroid sums."""
            sq = 0.0
            idx_chunks = []
            n_data = csum = 0
            for c in chunks:
                xq, indices, _ = self.vq(c)
                sq = sq + torch.sum(torch.square(c - xq))
                idx_chunks.append(indices)
                if K is not None:
                    n, s = cluster_sums(indices, c, K)
                    n_data, csum = n_data + n, csum + s
            if K is not None:
                sq, n_data, csum = self.reducer.sum(sq, n_data, csum)
            return idx_chunks, sq, n_data, csum

        distance = np.inf
        stopped = False
        while not stopped:
            next_size = self.curr_codebook_size * 2
            if next_size <= self.codebook_size:
                K = self.curr_codebook_size
                r = self._rand((K, L), cb.dtype) * self.perturb_factor
                cb[K:next_size] = cb[:K] - r
                cb[:K] += r
                self.curr_codebook_size = next_size

            prev_distance = distance
            for n in range(self.n_iter):
                K = self.curr_codebook_size
                _, sq, n_data, centroids = e_step(K)
                mask = self.min_data_per_cluster <= n_data
                sq_host, n_bad = self.reducer.read(         # the stated host read
                    sq, torch.sum(~mask).to(sq.dtype))
                distance = sq_host / T
                if callback is not None and callback(
                        iteration=n, codebook_size=K, distance=distance,
                        params=cb[:K]) is False:
                    stopped = True      # cooperative stop: no further
                    break               # splits either
                if n and abs(prev_distance - distance) \
                        / (distance + 1e-16) < self.eps:
                    break
                prev_distance = distance

                centroids = torch.where(
                    mask[:, None],
                    centroids / torch.clamp(n_data, min=1)[:, None].to(
                        centroids.dtype), centroids)
                n_bad = int(n_bad)
                if n_bad:
                    m = int(torch.argmax(n_data))
                    r = self._rand((n_bad, L), centroids.dtype) \
                        * self.perturb_factor
                    bad_idx = torch.nonzero(~mask)[:, 0]
                    centroids[bad_idx] = centroids[m] - r
                    centroids[m] += torch.mean(r, dim=0)
                cb[:K] = centroids

            if self.curr_codebook_size == self.codebook_size:
                break

        ret = [cb.detach().clone()]
        if return_indices:
            idx_chunks, _, _, _ = e_step()
            ret.append(torch.cat(idx_chunks, dim=0))
        ret.append(torch.tensor(distance))
        return ret

    def transform(self, x):
        xq, indices, _ = self.vq(x)
        return xq, indices


class PrincipalComponentAnalysis(BaseLearnerOp):
    """PCA by eigendecomposition of the sample, unbiased or correlation
    covariance; ``transform`` projects onto the top components.

    Host steps: one, the eigensolver's check of its result (on the card
    ``torch.linalg.eigh`` reads its status back), once per fit.  The
    moments are taken about the first chunk's mean, where the JAX package
    takes them about zero: the same covariance, but a float32 fit keeps the
    small eigenvalues that a large mean's cancellation loses (ROADMAP C.14).
    """

    def __init__(self, order: int, n_comp: int, *,
                 cov_type: str | int = "sample", sort: str = "descending",
                 batch_size=None, verbose=False, dtype=None,
                 device=None) -> None:
        super().__init__()
        if order < 0:
            raise ValueError("order must be non-negative.")
        if n_comp <= 0 or order + 1 < n_comp:
            raise ValueError("n_comp must be in [1, order + 1].")
        if sort not in ("ascending", "descending"):
            raise ValueError("sort must be ascending or descending.")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        if cov_type in (0, "sample"):
            self.cov_type = "sample"
        elif cov_type in (1, "unbiased"):
            self.cov_type = "unbiased"
        elif cov_type in (2, "correlation"):
            self.cov_type = "correlation"
        else:
            raise ValueError(f"cov_type {cov_type} is not supported.")
        self.n_comp = n_comp
        self.sort = sort
        self.batch_size = batch_size
        dtype = dtype or torch.get_default_dtype()
        dev = resolve_device(device)
        L = order + 1
        self.register_buffer("s", torch.zeros(n_comp, dtype=dtype,
                                              device=dev))
        self.register_buffer("V", torch.zeros((n_comp, L), dtype=dtype,
                                              device=dev))
        self.register_buffer("m", torch.zeros(L, dtype=dtype, device=dev))

    def cov(self, x0, x1, x2):
        c = x2 / x0 - torch.outer(x1, x1) / (x0 * x0)
        if self.cov_type == "unbiased":
            c = c * (x0 / (x0 - 1))
        elif self.cov_type == "correlation":
            v = torch.sqrt(torch.diag(c))
            c = c / torch.outer(v, v)
        return c

    @torch.no_grad()
    def forward(self, x):
        chunks = as_chunks(x, self.batch_size, self.m.device, self.m.dtype)
        if chunks[0].ndim != 2:
            raise ValueError("Input vectors must be 2D.")
        x0 = sum(c.shape[0] for c in chunks)
        if x0 <= self.n_comp:
            raise RuntimeError("Number of data samples is too small.")
        # The moments of the data less the first chunk's mean: the same
        # covariance, without the cancellation of a large mean in float32.
        shift = torch.mean(chunks[0], dim=0)
        x1 = sum(torch.sum(c - shift, dim=0) for c in chunks)
        x2 = sum((c - shift).T @ (c - shift) for c in chunks)
        m = shift + x1 / x0
        val, vec = torch.linalg.eigh(self.cov(x0, x1, x2))
        val = val[-self.n_comp:]
        vec = vec[:, -self.n_comp:]
        if self.sort == "descending":
            val = torch.flip(val, (-1,))
            vec = torch.flip(vec, (-1,))
        self.s, self.V, self.m = val, vec.T.contiguous(), m
        return self.s, self.V, self.m

    def center(self, x):
        return x - self.m

    def _descending(self):
        if self.sort == "ascending":
            return torch.flip(self.V.T, (-1,)), torch.flip(self.s, (-1,))
        return self.V.T, self.s

    def whiten(self, x):
        V, s = self._descending()
        d = torch.sqrt(torch.clamp(s, min=1e-10))
        return torch.matmul(x, V / d)

    def transform(self, x):
        return torch.matmul(self.center(x), self._descending()[0])


class IndependentComponentAnalysis(BaseLearnerOp):
    """FastICA with the fixed-point iteration on whitened data.

    Host steps: the PCA's one and the first decorrelation's, then two an
    iteration: the symmetric decorrelation's eigensolver check and the
    convergence criterion.
    """

    def __init__(self, order: int, n_comp: int, *, func: str = "logcosh",
                 n_iter: int = 100, eps: float = 1e-4, batch_size=None,
                 seed: int = 0, verbose=False, dtype=None,
                 device=None) -> None:
        super().__init__()
        if n_iter <= 0:
            raise ValueError("n_iter must be positive.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        if func not in ("logcosh", "gauss"):
            raise ValueError(f"func {func} is not supported.")
        self.n_comp = n_comp
        self.n_iter = n_iter
        self.eps = eps
        self.batch_size = batch_size
        self.func = func
        self.pca = PrincipalComponentAnalysis(
            order, n_comp, batch_size=batch_size, dtype=dtype,
            device=device)
        self.register_buffer("W", initial_codebook(
            seed, (n_comp, n_comp), dtype or torch.get_default_dtype(),
            resolve_device(device)))

    def g(self, u):
        if self.func == "logcosh":
            return torch.tanh(u)
        return u * torch.exp(-(u ** 2) / 2)

    def g_prime(self, u):
        if self.func == "logcosh":
            return 1 - torch.tanh(u) ** 2
        return (1 - u ** 2) * torch.exp(-(u ** 2) / 2)

    @torch.no_grad()
    def forward(self, x, callback=None):
        chunks = as_chunks(x, self.batch_size, self.W.device, self.W.dtype)
        self.pca(chunks)

        def decorrelate(W):
            s, V = torch.linalg.eigh(W @ W.T)
            d = 1 / torch.sqrt(torch.clamp(s, min=1e-10))
            return (V * d) @ V.T @ W

        W = decorrelate(self.W)
        xqs = [self.pca.whiten(self.pca.center(c)) for c in chunks]
        T = sum(c.shape[0] for c in chunks)
        for n in range(self.n_iter):
            prev_W = W
            term1 = 0
            term2 = 0
            for xq in xqs:
                Wx = W @ xq.T
                term1 = term1 + self.g(Wx) @ xq
                term2 = term2 + W * torch.sum(self.g_prime(Wx), dim=1,
                                              keepdim=True)
            W = decorrelate((term1 - term2) / T)
            similarity = torch.abs(torch.diagonal(W @ prev_W.T))
            criterion = float(torch.max(torch.abs(similarity - 1)))
            if callback is not None and callback(
                    iteration=n, criterion=criterion, params=W) is False:
                break
            if criterion < self.eps:
                break

        self.W = W
        s2 = sum(torch.sum(torch.square(self.transform(c)), dim=0)
                 for c in chunks)
        self.W = W / torch.sqrt(s2 / T)[:, None]
        return self.W

    def transform(self, x):
        return (self.W @ self.pca.whiten(self.pca.center(x)).T).T


class NonnegativeMatrixFactorization(BaseLearnerOp):
    """Multiplicative updates under the beta-divergence.

    Host steps: one read when the fit starts (whether every input is
    positive) and one per iteration (the divergence, for the convergence
    test).
    """

    def __init__(self, n_data: int, order: int, n_comp: int, *,
                 beta: float = 0, n_iter: int = 100, eps: float = 1e-5,
                 act_norm: bool = False, batch_size=None, seed: int = 0,
                 verbose=False, dtype=None, device=None) -> None:
        super().__init__()
        if n_data <= 0 or order < 0 or n_comp <= 0:
            raise ValueError("invalid size arguments.")
        if n_iter <= 0:
            raise ValueError("n_iter must be positive.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.beta = beta
        self.n_iter = n_iter
        self.eps = eps
        self.act_norm = act_norm
        self.batch_size = batch_size
        if beta < 1:
            self.phi = 1 / (2 - beta)
        elif 2 < beta:
            self.phi = 1 / (beta - 1)
        else:
            self.phi = 1.0
        dtype = dtype or torch.get_default_dtype()
        dev = resolve_device(device)
        k1, k2 = prng.split(prng.PRNGKey(seed))
        U = threefry.uniform(k1, (n_data, n_comp), dtype, dev)
        if act_norm:
            U = U / torch.sum(U, dim=1, keepdim=True)
        self.register_buffer("U", U)
        self.register_buffer("H", threefry.uniform(k2, (n_comp, order + 1),
                                                   dtype, dev))

    def _update(self, U, z):
        """One multiplicative update of the coefficients of ``z``."""
        y = U @ self.H
        y2 = z * y ** (self.beta - 2)
        y1 = y ** (self.beta - 1)
        return U * ((y2 @ self.H.T) / (y1 @ self.H.T)) ** self.phi

    @torch.no_grad()
    def forward(self, x, callback=None):
        chunks = as_chunks(x, self.batch_size, self.U.device, self.U.dtype)
        if chunks[0].ndim != 2:
            raise ValueError("Input vectors must be 2D.")
        if bool(torch.stack([torch.any(c <= 0) for c in chunks]).any()):
            raise ValueError("Input vectors must be positive.")
        if sum(c.shape[0] for c in chunks) != self.U.shape[0]:
            raise ValueError("Data length must match n_data.")
        beta, phi = self.beta, self.phi

        # The coefficient update is row-local and the dictionary update
        # sums (K, M+1) statistics, so the chunked sweep equals the
        # full-batch update.
        prev_div = np.inf
        for n in range(self.n_iter):
            H_numer = 0
            H_denom = 0
            t1 = 0
            for z in chunks:
                t2 = t1 + z.shape[0]
                U = self._update(self.U[t1:t2], z)
                if self.act_norm:
                    U = U / torch.sum(U, dim=1, keepdim=True)
                self.U[t1:t2] = U
                y = U @ self.H
                H_numer = H_numer + U.T @ (z * y ** (beta - 2))
                H_denom = H_denom + U.T @ y ** (beta - 1)
                t1 = t2
            self.H = self.H * (H_numer / H_denom) ** phi

            div = 0.0
            t1 = 0
            for z in chunks:
                t2 = t1 + z.shape[0]
                y = self.U[t1:t2] @ self.H
                if beta == 0:
                    r = z / y
                    div = div + torch.sum(r - torch.log(r) - 1)
                elif beta == 1:
                    div = div + torch.sum(z * torch.log(z / y) - (z - y))
                else:
                    b1 = beta - 1
                    r1 = z * (z ** b1 - y ** b1) / b1
                    r2 = (z ** beta - y ** beta) / beta
                    div = div + torch.sum(r1 - r2)
                t1 = t2
            div = float(div)                  # the stated host read
            if callback is not None and callback(
                    iteration=n, divergence=div,
                    params=(self.U, self.H)) is False:
                break
            if n and abs(prev_div - div) / (div + 1e-16) < self.eps:
                break
            prev_div = div

        return (self.U, self.H), torch.tensor(div)

    @torch.no_grad()
    def transform(self, x):
        """Coefficients of new data on the learned dictionary (fixed H),
        from uniform draws of ``PRNGKey(0)``."""
        z = torch.as_tensor(x, device=self.H.device)
        U = threefry.uniform(prng.PRNGKey(0), (z.shape[0], self.H.shape[0]),
                             z.dtype, z.device)
        for _ in range(self.n_iter):
            U = self._update(U, z)
        return U
