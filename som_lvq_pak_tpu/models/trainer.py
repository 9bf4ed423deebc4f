"""Production training drivers: the device-throughput front end.

The parity trainers (som.som_train / lvq.olvq1_train) replicate the
reference's online loops bit-for-bit; these drivers are the
scale path — minibatch steps on one chip or a (data, model) mesh, with
streaming input, interval checkpoints (codebook + alphas + step + RNG)
and resume.  They compose the pieces the reference keeps implicit:
LOADMODE_BUFFER streaming (datafile.c:237-344) -> data.streaming,
snapshot checkpoints (lvq_pak.c:663-867) -> utils.checkpoint,
the winner/update loops (som_rout.c:556-671) -> fused device steps."""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Optional, Union

import numpy as np

from ..data.dataset import Dataset, Neighborhood, Topology
from ..utils.checkpoint import Checkpointer, TrainState
from ..utils.progress import StepTimer
from .common import alpha_schedule, radius_schedule
from .fast import olvq1_batch_step, som_batch_step, unit_coords


class SOMTrainer:
    """Minibatch SOM training at device speed.

    mesh=None runs the single-chip fused step; passing a
    jax.sharding.Mesh with ('data', 'model') axes runs the sharded step
    (codebook TP + batch DP, parallel.sharded)."""

    def __init__(
        self,
        codes: Dataset,
        batch_size: int = 1024,
        update: str = "sum",
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
        stream_bf16: bool = False,
    ):
        """`stream_bf16=True` ships streamed input batches host->device in
        bfloat16, halving the transfer bytes; samples are upcast on
        device, so only the input quantization changes (quality-gated in
        tests, not bit parity)."""
        if not codes.is_map:
            raise ValueError("SOMTrainer needs a map codebook")
        self.stream_bf16 = stream_bf16
        self.meta = codes
        self.batch_size = batch_size
        self.update = update
        self.mesh = mesh
        self.seed = seed
        self.gaussian = codes.neigh == Neighborhood.GAUSSIAN
        self.coords = unit_coords(
            codes.xdim, codes.ydim, codes.topol == Topology.HEXA
        )
        self.ckpt = None
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_dir is not None:
            self.ckpt = Checkpointer(checkpoint_dir, background=True)

        self._sharded_cache = {}

    # -- internals -------------------------------------------------------

    def _sharded_step(self, flags):
        """Sharded step closure for (masked, weighted, fixed) flags."""
        if flags not in self._sharded_cache:
            from ..parallel.sharded import make_sharded_som_train_step

            masked, weighted, fixed = flags
            self._sharded_cache[flags] = make_sharded_som_train_step(
                self.mesh, gaussian=self.gaussian, xdim=self.meta.xdim,
                hexa=self.meta.topol == Topology.HEXA,
                masked=masked, weighted=weighted, fixed=fixed,
            )
        return self._sharded_cache[flags]

    def _one_step(self, M, xb, a, r, mask=None, weights=None, fixed_bmu=None):
        import jax.numpy as jnp

        if getattr(xb, "dtype", None) is not None and xb.dtype != jnp.float32:
            xb = jnp.asarray(xb).astype(jnp.float32)  # bf16-streamed batch
        if self.mesh is None:
            return som_batch_step(
                M, xb, self.coords, jnp.float32(a), jnp.float32(r),
                gaussian=self.gaussian, update=self.update,
                xdim=self.meta.xdim,
                hexa=self.meta.topol == Topology.HEXA,
                mask=mask, weights=weights, fixed_bmu=fixed_bmu,
            )
        from ..parallel.sharded import shard_arrays

        step = self._sharded_step(
            (mask is not None, weights is not None, fixed_bmu is not None)
        )
        cs, xs = shard_arrays(self.mesh, M, xb)
        extras = []
        from jax.sharding import NamedSharding, PartitionSpec as P

        import jax

        for arr, spec in ((mask, P("data", None)), (weights, P("data")),
                          (fixed_bmu, P("data"))):
            if arr is not None:
                extras.append(jax.device_put(arr, NamedSharding(self.mesh, spec)))
        return step(cs, xs, jnp.float32(a), jnp.float32(r), *extras)

    # -- API -------------------------------------------------------------

    def fit(
        self,
        data: Union[Dataset, Iterable[Dataset]],
        rlen: int,
        alpha: float,
        radius: float,
        alpha_type: str = "linear",
        resume: bool = True,
        progress: Optional[StepTimer] = None,
        use_weights: bool = False,
        use_fixed: bool = False,
        allow_short_stream: bool = False,
    ) -> Dataset:
        """Train for `rlen` samples (grouped into batches).

        `data` is a Dataset — consumed in per-lap shuffled order, the
        batch analogue of the reference's -rand lap semantics
        (datafile.c:338-341) — or an iterable of chunk Datasets (e.g.
        StreamingReader.chunks(laps=N)); chunks prefetch to the device
        one step ahead.  A stream that runs dry before `rlen` samples
        raises (pass laps=None for an endless stream, or
        allow_short_stream=True to accept the truncated run).

        use_weights / use_fixed: honor per-sample weight= / fixed=
        tokens like the reference trainers (som_rout.c:612-632; off by
        default like the C -weights/-fixed flags).  Masks always apply.
        With a checkpoint dir and resume=True, continues from the latest
        step."""
        import jax
        import jax.numpy as jnp

        nb = max(1, rlen // self.batch_size)
        talp = alpha_schedule(rlen, alpha, alpha_type)[:: max(1, self.batch_size)][:nb]
        trad = radius_schedule(rlen, radius)[:: max(1, self.batch_size)][:nb]

        start = 0
        M = jnp.asarray(self.meta.points)
        key = jax.random.PRNGKey(self.seed)
        if self.ckpt is not None and resume:
            st = self.ckpt.load()
            if st is not None and st.step < nb:
                M = jnp.asarray(st.codes)
                start = st.step
                if st.prng_key is not None:
                    key = jnp.asarray(st.prng_key)

        xdim = self.meta.xdim

        def fixed_flat(ds: Dataset):
            if not use_fixed or ds.fixed is None:
                return None
            fx = ds.fixed
            return np.where(
                (fx[:, 0] >= 0) & (fx[:, 1] >= 0),
                fx[:, 1] * xdim + fx[:, 0], -1,
            ).astype(np.int32)

        if isinstance(data, Dataset):
            X = jnp.asarray(data.points)
            mk = None if data.mask is None else jnp.asarray(data.mask)
            wt = (jnp.asarray(data.weight)
                  if use_weights and data.weight is not None else None)
            ff = fixed_flat(data)
            ff = None if ff is None else jnp.asarray(ff)
            n = data.n

            perm_cache = {}

            def lap_perm(lap):
                # resume-safe: lap perms derive from fold_in(seed, lap),
                # not from consumed key state; cache the current lap's
                # (recomputing an n-element permutation per batch is an
                # O(n) host pull each step)
                if lap not in perm_cache:
                    perm_cache.clear()
                    perm_cache[lap] = np.asarray(
                        jax.random.permutation(jax.random.fold_in(key, lap), n))
                return perm_cache[lap]

            def batches():
                # per-lap shuffled order: lap l is an independent
                # permutation of all n samples, batches cut from the
                # concatenated laps — the batch analogue of the
                # reference's per-lap shuffle (datafile.c:338-341)
                for b in range(start, nb):
                    lo = b * self.batch_size
                    idx_np = np.empty((self.batch_size,), dtype=np.int64)
                    got = 0
                    while got < self.batch_size:
                        lap, off = divmod(lo + got, n)
                        perm = lap_perm(lap)
                        take = min(self.batch_size - got, n - off)
                        idx_np[got:got + take] = perm[off:off + take]
                        got += take
                    idx = jnp.asarray(idx_np)
                    yield (b, X[idx],
                           None if mk is None else mk[idx],
                           None if wt is None else wt[idx],
                           None if ff is None else ff[idx])
        else:
            chunk_iter = iter(data)

            def batches():
                # Buffer chunks HOST-side (NumPy), ship SUPERBLOCKS of
                # ~16 MB in one device_put each, and slice per-batch
                # views on the DEVICE: one transfer per block instead of
                # one per batch, and stream_bf16 halves the bytes.  The
                # reader's background thread still parses ahead;
                # device_put is async against the chained steps.
                stream_dtype = jnp.bfloat16 if self.stream_bf16 else np.float32

                def pack(chunk):
                    return (
                        np.ascontiguousarray(chunk.points),
                        chunk.mask,
                        (chunk.weight if use_weights and chunk.weight is not None
                         else None),
                        fixed_flat(chunk),
                        chunk.n,
                    )

                def next_chunk():
                    try:
                        return pack(next(chunk_iter))
                    except StopIteration:
                        return None

                bufs = []  # list of (X, mk, wt, ff, n) host tuples
                buffered = 0
                b = start
                pending = next_chunk()  # parsed one chunk ahead
                # resume-exact streaming: fast-forward start*batch_size
                # samples so batch b trains on the same stream positions
                # it would have seen in the uninterrupted run (a resumed
                # late-schedule batch must not retrain the stream's head)
                skip = start * self.batch_size
                while skip > 0 and pending is not None:
                    pending, skip = _skip_stream_samples(pending, skip)
                    if pending is None:
                        pending = next_chunk()
                s = self.batch_size
                itemsize = 2 if self.stream_bf16 else 4
                target_rows = max(s, (16 << 20) // max(1, D * itemsize))
                while b < nb:
                    # fill to at least one batch, ideally a full block
                    while (buffered < s
                           or (buffered < target_rows and pending is not None)):
                        if pending is None:
                            if buffered >= s:
                                break
                            if allow_short_stream:
                                return
                            raise RuntimeError(
                                f"input stream exhausted at batch {b}/{nb} "
                                f"({buffered} samples buffered, "
                                f"{s} needed): size laps to "
                                "cover rlen, pass laps=None, or set "
                                "allow_short_stream=True"
                            )
                        bufs.append(pending)
                        buffered += pending[-1]
                        pending = next_chunk()

                    def cat(i, fill, shape, dtype):
                        parts = [t[i] for t in bufs]
                        if all(p is None for p in parts):
                            return None
                        parts = [
                            (p if p is not None
                             else np.full((t[-1],) + shape, fill, dtype=dtype))
                            for p, t in zip(parts, bufs)
                        ]
                        return np.concatenate(parts) if len(parts) > 1 else parts[0]

                    Dc = bufs[0][0].shape[1]
                    X = cat(0, 0.0, (Dc,), np.float32)
                    mk = cat(1, 0, (Dc,), np.uint8)
                    wt = cat(2, 0.0, (), np.float32)
                    ff = cat(3, -1, (), np.int32)
                    # ship whole batches only; the remainder stays HOST-
                    # side for the next block (mixing device leftovers
                    # back into np.concatenate would fetch them D2H)
                    nfull = min(buffered // s, nb - b) * s
                    Xd = jax.device_put(
                        np.ascontiguousarray(X[:nfull], dtype=stream_dtype))
                    mkd = None if mk is None else jax.device_put(mk[:nfull])
                    wtd = None if wt is None else jax.device_put(wt[:nfull])
                    ffd = None if ff is None else jax.device_put(ff[:nfull])
                    # per-batch mask/fixed presence, decided on the HOST copy:
                    # a clean batch inside a block that contains masked
                    # chunks elsewhere must yield mask=None — an all-zero
                    # mask array would route it down the masked kernel,
                    # whose different rounding can flip near-tie winners —
                    # and consumers then branch on `is not None` alone
                    # with no per-batch device sync (review finding r5)
                    mk_any = (None if mk is None else
                              [bool(mk[o:o + s].any())
                               for o in range(0, nfull, s)])
                    ff_any = (None if ff is None else
                              [bool((ff[o:o + s] >= 0).any())
                               for o in range(0, nfull, s)])
                    off = 0
                    j = 0
                    while off < nfull and b < nb:
                        yield (b, Xd[off:off + s],
                               (mkd[off:off + s]
                                if mkd is not None and mk_any[j] else None),
                               None if wtd is None else wtd[off:off + s],
                               (ffd[off:off + s]
                                if ffd is not None and ff_any[j] else None))
                        off += s
                        buffered -= s
                        b += 1
                        j += 1
                    bufs = [(X[nfull:], None if mk is None else mk[nfull:],
                             None if wt is None else wt[nfull:],
                             None if ff is None else ff[nfull:], buffered)]

        D = self.meta.dim
        last_ckpt = start
        for b, xb, mk_b, wt_b, ff_b in batches():
            M = self._one_step(M, xb, talp[b], trad[b],
                               mask=mk_b, weights=wt_b, fixed_bmu=ff_b)
            if progress is not None:
                progress.step(self.batch_size)
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) - last_ckpt >= self.checkpoint_interval):
                last_ckpt = b + 1
                self.ckpt.save(TrainState(
                    codes=np.asarray(M, dtype=np.float32), step=b + 1,
                    prng_key=np.asarray(key),
                    extra={"alpha": float(alpha), "radius": float(radius)},
                ))

        if self.ckpt is not None:
            self.ckpt.save(TrainState(
                codes=np.asarray(M), step=nb, prng_key=np.asarray(key),
            ))
            self.ckpt.wait()
        self.meta = replace(self.meta, points=np.asarray(M), comments=[])
        return self.meta


def _skip_stream_samples(t, skip):
    """Drop the first `skip` samples from a packed chunk tuple
    (*arrays_or_None, n) — the resume-exact stream fast-forward shared
    by SOMTrainer's and the LVQ drivers' streaming branches.  Returns
    (tuple_or_None, remaining_skip); None = the chunk was consumed
    entirely."""
    n = t[-1]
    if n <= skip:
        return None, skip - n
    if skip == 0:
        return t, 0
    return tuple(a if a is None else a[skip:] for a in t[:-1]) + (n - skip,), 0


def _labeled_batches(data, start, nb, batch_size, keybox,
                     allow_short_stream=False):
    """Yield (b, xb, xlab, mask) minibatches for the LVQ drivers.

    `data` is a Dataset (batches sampled with replacement, advancing
    keybox['key'] one split per batch — resume-stable because the key is
    checkpointed) or an iterable of chunk Datasets (host-side buffering
    with fixed-shape device transfers; resume fast-forwards
    start*batch_size stream samples — see SOMTrainer's streaming branch
    for the rationale)."""
    import jax

    np_ = np
    if isinstance(data, Dataset):
        import jax.numpy as jnp

        X = jnp.asarray(data.points)
        xlab = jnp.asarray(data.first_labels())
        mk = None if data.mask is None else jnp.asarray(data.mask)
        n = data.n
        for b in range(start, nb):
            keybox["key"], sub = jax.random.split(keybox["key"])
            idx = jax.random.randint(sub, (batch_size,), 0, n)
            yield (b, X[idx], xlab[idx], None if mk is None else mk[idx])
        return

    chunk_iter = iter(data)
    bufs = []
    buffered = 0
    b = start
    skip = start * batch_size
    s = batch_size
    # superblock transfers (see SOMTrainer's streaming branch): ship
    # ~16 MB blocks in one device_put each and slice batches on device
    target_rows = None
    while b < nb:
        while (buffered < s
               or (target_rows is not None and buffered < target_rows)):
            try:
                c = next(chunk_iter)
            except StopIteration:
                if buffered >= s:
                    break
                if allow_short_stream:
                    return
                raise RuntimeError(
                    f"input stream exhausted at batch {b}/{nb}: "
                    "size laps to cover rlen, pass laps=None, "
                    "or set allow_short_stream=True")
            t = (np_.ascontiguousarray(c.points), c.first_labels(),
                 c.mask, c.n)
            if skip > 0:
                t, skip = _skip_stream_samples(t, skip)
                if t is None:
                    continue
            if target_rows is None:
                target_rows = max(s, (16 << 20) // max(1, t[0].shape[1] * 4))
            bufs.append(t)
            buffered += t[3]
        X = np_.concatenate([t[0] for t in bufs])
        L = np_.concatenate([t[1] for t in bufs])
        has_mask = any(t[2] is not None for t in bufs)
        if has_mask:
            mk = np_.concatenate([
                (t[2] if t[2] is not None
                 else np_.zeros((t[3], X.shape[1]), np_.uint8))
                for t in bufs])
        else:
            mk = None
        nfull = min(buffered // s, nb - b) * s
        Xd = jax.device_put(X[:nfull])
        Ld = jax.device_put(L[:nfull])
        mkd = None if mk is None else jax.device_put(mk[:nfull])
        mk_any = (None if mk is None else
                  [bool(mk[o:o + s].any()) for o in range(0, nfull, s)])
        off = 0
        j = 0
        while off < nfull and b < nb:
            yield (b, Xd[off:off + s], Ld[off:off + s],
                   (mkd[off:off + s]
                    if mkd is not None and mk_any[j] else None))
            off += s
            buffered -= s
            b += 1
            j += 1
        bufs = [(X[nfull:], L[nfull:],
                 None if mk is None else mk[nfull:], buffered)]


class LVQTrainer:
    """Minibatch lvq1 / lvq2.1 / lvq3 training at device speed — the
    production-driver counterpart of the reference's lvqtrain dispatch
    (lvqtrain.c:214-237) for the fixed-alpha algorithms; olvq1's
    adaptive-alpha driver is OLVQ1Trainer.  Batched steps:
    models.fast.lvq1_batch_step / lvq23_batch_step."""

    def __init__(
        self,
        codes: Dataset,
        algorithm: str = "lvq1",
        batch_size: int = 1024,
        winlen: float = 0.3,
        epsilon: float = 0.1,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
    ):
        """`mesh`: a (data, model) jax.sharding.Mesh runs the sharded
        step (codebook TP + batch DP, parallel.sharded.sharded_lvq_step;
        masks unsupported there — masked batches raise)."""
        if algorithm not in ("lvq1", "lvq2", "lvq3"):
            raise ValueError(
                f"unknown algorithm {algorithm!r} (lvq1|lvq2|lvq3; "
                "use OLVQ1Trainer for olvq1)")
        self.meta = codes
        self.algorithm = algorithm
        self.batch_size = batch_size
        self.winlen = float(winlen)
        self.epsilon = float(epsilon)
        self.mesh = mesh
        self.seed = seed
        self._sharded = None
        if mesh is not None:
            from ..parallel.sharded import make_sharded_lvq_train_step

            self._sharded = make_sharded_lvq_train_step(
                mesh, algorithm=algorithm, winlen=self.winlen,
                epsilon=self.epsilon)
        self.ckpt = None
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_dir is not None:
            self.ckpt = Checkpointer(checkpoint_dir, background=True)

    def fit(self, data: Union[Dataset, Iterable[Dataset]], rlen: int,
            alpha: float, alpha_type: str = "linear",
            resume: bool = True,
            progress: Optional[StepTimer] = None,
            allow_short_stream: bool = False) -> Dataset:
        """Train for `rlen` samples (grouped into batches); the alpha
        schedule (linear_alpha / inverse_t_alpha, lvq_pak.c:901-921) is
        evaluated at each batch's first sample."""
        import jax
        import jax.numpy as jnp

        from .fast import lvq1_batch_step, lvq23_batch_step

        nb = max(1, rlen // self.batch_size)
        talp = alpha_schedule(rlen, alpha, alpha_type)[
            :: max(1, self.batch_size)][:nb]
        M = jnp.asarray(self.meta.points)
        clabels = jnp.asarray(self.meta.first_labels())
        keybox = {"key": jax.random.PRNGKey(self.seed)}
        start = 0
        if self.ckpt is not None and resume:
            st = self.ckpt.load()
            if st is not None and st.step < nb:
                M = jnp.asarray(st.codes)
                if st.prng_key is not None:
                    keybox["key"] = jnp.asarray(st.prng_key)
                start = st.step

        last_ckpt = start
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            M = jax.device_put(M, NamedSharding(self.mesh, P("model", None)))
        for b, xb, xl, mb in _labeled_batches(
                data, start, nb, self.batch_size, keybox, allow_short_stream):
            a = jnp.float32(talp[b])
            if self.mesh is not None:
                if mb is not None and bool(jnp.any(mb != 0)):
                    raise ValueError(
                        "LVQTrainer(mesh=...): masked batches are not "
                        "supported on the sharded step")
                from jax.sharding import NamedSharding, PartitionSpec as P

                M = self._sharded(
                    M, clabels,
                    jax.device_put(xb, NamedSharding(self.mesh, P("data", None))),
                    jax.device_put(xl, NamedSharding(self.mesh, P("data"))),
                    a)
            elif self.algorithm == "lvq1":
                M = lvq1_batch_step(M, clabels, xb, xl, a, mask=mb)
            else:
                M = lvq23_batch_step(
                    M, clabels, xb, xl, a, jnp.float32(self.winlen),
                    epsilon=jnp.float32(self.epsilon),
                    lvq3=self.algorithm == "lvq3", mask=mb)
            if progress is not None:
                progress.step(self.batch_size)
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) - last_ckpt >= self.checkpoint_interval):
                last_ckpt = b + 1
                self.ckpt.save(TrainState(
                    codes=np.asarray(M), step=b + 1,
                    prng_key=np.asarray(keybox["key"])))
        if self.ckpt is not None:
            self.ckpt.save(TrainState(codes=np.asarray(M), step=nb,
                                      prng_key=np.asarray(keybox["key"])))
            self.ckpt.wait()
        self.meta = replace(self.meta, points=np.asarray(M), comments=[])
        return self.meta


class OLVQ1Trainer:
    """Minibatch olvq1 training with per-code adaptive learning rates
    (sharded over the mesh when given)."""

    def __init__(
        self,
        codes: Dataset,
        batch_size: int = 1024,
        alpha: float = 0.3,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 0,
        seed: int = 0,
    ):
        self.meta = codes
        self.batch_size = batch_size
        self.clip = float(alpha)
        self.mesh = mesh
        self.seed = seed
        self.ckpt = None
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_dir is not None:
            self.ckpt = Checkpointer(checkpoint_dir, background=True)
        if mesh is not None:
            from ..parallel.sharded import make_sharded_olvq1_train_step

            self._sharded = make_sharded_olvq1_train_step(mesh, clip=self.clip)

    def fit(self, data: Union[Dataset, Iterable[Dataset]], rlen: int,
            resume: bool = True,
            progress: Optional[StepTimer] = None,
            allow_short_stream: bool = False) -> Dataset:
        """`data` is a Dataset (batches sampled with replacement) or an
        iterable of chunk Datasets (StreamingReader.chunks — the
        reference's -buffer reading for lvqtrain, lvqtrain.c:181);
        a stream that runs dry before rlen raises unless
        allow_short_stream=True."""
        import jax
        import jax.numpy as jnp

        nb = max(1, rlen // self.batch_size)
        M = jnp.asarray(self.meta.points)
        clabels = jnp.asarray(self.meta.first_labels())
        alphas = jnp.full((self.meta.n,), self.clip, dtype=jnp.float32)
        keybox = {"key": jax.random.PRNGKey(self.seed)}
        start = 0
        if self.ckpt is not None and resume:
            st = self.ckpt.load()
            if st is not None and st.step < nb:
                M = jnp.asarray(st.codes)
                if st.alphas is not None:
                    alphas = jnp.asarray(st.alphas)
                if st.prng_key is not None:
                    keybox["key"] = jnp.asarray(st.prng_key)
                start = st.step

        for b, xb, xl, mb in _labeled_batches(
                data, start, nb, self.batch_size, keybox, allow_short_stream):
            if self.mesh is None:
                M, alphas = olvq1_batch_step(M, clabels, alphas, xb, xl,
                                             clip=self.clip, mask=mb)
            else:
                from jax.sharding import NamedSharding, PartitionSpec as P

                M, alphas = self._sharded(
                    jax.device_put(M, NamedSharding(self.mesh, P("model", None))),
                    clabels, alphas,
                    jax.device_put(xb, NamedSharding(self.mesh, P("data", None))),
                    jax.device_put(xl, NamedSharding(self.mesh, P("data"))),
                )
            if progress is not None:
                progress.step(self.batch_size)
            if (self.ckpt is not None and self.checkpoint_interval
                    and (b + 1) % self.checkpoint_interval == 0):
                self.ckpt.save(TrainState(codes=np.asarray(M), step=b + 1,
                                          alphas=np.asarray(alphas),
                                          prng_key=np.asarray(keybox["key"])))
        if self.ckpt is not None:
            self.ckpt.save(TrainState(codes=np.asarray(M), step=nb,
                                      alphas=np.asarray(alphas),
                                      prng_key=np.asarray(keybox["key"])))
            self.ckpt.wait()
        self.meta = replace(self.meta, points=np.asarray(M), comments=[])
        return self.meta
