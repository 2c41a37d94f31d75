"""Composable attention core: one tile-level online-softmax template (the
port of ``repro.kernels.attention_core``, tile programs for the port's
compiler, ``repro_torch.core``).

Every attention kernel in this repo — flash (training/prefill), paged
decode, chunked prefill, MLA, paged MLA, MLA prefill — is the same
dataflow: stream KV tiles through the grid pipeline, score them against a
resident Q tile, and fold each tile into a numerically-stable online
softmax (running-max rescale of the output accumulator and log-sum).  The
paper's composability thesis says the variants should differ by
*composition points*, not copy-pasted loops; this module is that template.

Composition points (each a plain Python callable evaluated at trace time —
the kernels stay ordinary ``@T.prim_func`` bodies):

* **KV source** — ``load_kv(k)`` stages step ``k``'s K/V tiles into shared
  memory: a contiguous window (``K[bz, h, k * block_N, 0]``) or a
  block-table page gather (``KPages[Tables[bz, k], 0, 0]`` — the scalar-
  prefetch path, see DESIGN.md §5.1).
* **Q packing / scoring** — :func:`scores` fills the score tile from one
  or more Q·Kᵀ GEMMs: a per-head query block, a GQA group-major packing,
  or MLA's latent+rope split (two GEMMs accumulating into one tile).
* **Score mask** — a ``mask(i, j) -> bool-expr`` composed from the
  factories below: causal, ragged live-length, sliding window, or the
  two-part ctx+chunk masks of chunked prefill.

:class:`OnlineSoftmax` owns the rescaling loop itself (the part the four
kernels used to hand-roll): running max with the ``-inf`` clamp, exp2
scaling by ``log2(e)``, l/m fragment carries, and the final normalize.
"""
from ..core import lang as T
from ..core.layout import vector_elems

# Clamp the running max before differencing: fully-masked tiles leave it at
# -inf, and (-inf) - (-inf) = nan.  -2^20; exp2 underflows long before.
NEG_CLAMP = -1048576.0


class OnlineSoftmax:
    """Online-softmax accumulator state over ``rows`` query rows.

    Allocates the m/l fragment carries (persisting over the pipelined KV
    loop; in shared memory on the CUDA backend today) and fills them; construct it in the kernel's PRE phase, feed score tiles through
    :meth:`update` inside the pipelined loop, then :meth:`finalize`.

    Variant knobs (each preserves an existing kernel's exact op sequence):

    * ``running_max`` — False refreshes the max per tile instead of
      carrying it (the paper's Fig. 18 MLA formulation).
    * ``clamp_current`` — clamp the current max as well as the previous
      one (fully-masked tiles can leave *either* at -inf).
    * ``safe_div`` — divide by ``max(l, 1e-30)`` so fully-masked rows
      (empty slots, dead chunk rows) emit zeros rather than nan.
    * ``shared_scores`` — optional shared-memory staging buffer for the
      probability tile feeding the P·V GEMM (MLA's ``S_shared``).
    """

    def __init__(self, rows, v_dim, scale, accum_dtype="float32", *,
                 running_max=True, clamp_current=True, safe_div=False,
                 shared_scores=None):
        self.rows, self.v_dim, self.scale = rows, v_dim, scale
        self.accum_dtype = accum_dtype
        self.running_max = running_max
        self.clamp_current = clamp_current
        self.safe_div = safe_div
        self.shared_scores = shared_scores
        self.acc_o = T.alloc_fragment((rows, v_dim), accum_dtype)
        self.scores_max = T.alloc_fragment((rows,), accum_dtype)
        self.scores_max_prev = T.alloc_fragment((rows,), accum_dtype)
        self.scores_scale = T.alloc_fragment((rows,), accum_dtype)
        self.scores_sum = T.alloc_fragment((rows,), accum_dtype)
        self.logsum = T.alloc_fragment((rows,), accum_dtype)
        T.fill(self.acc_o, 0.0)
        T.fill(self.logsum, 0.0)
        T.fill(self.scores_max, -T.infinity(accum_dtype))

    def _cur(self, i):
        m = self.scores_max[i]
        return T.maximum(m, NEG_CLAMP) if self.clamp_current else m

    def update(self, acc_s, cols, v_source, mask=None):
        """Fold one scored KV tile into the accumulator.

        ``acc_s`` is the (rows, cols) score tile (already Q·Kᵀ-filled, see
        :func:`scores`), ``v_source`` the tile's V (or latent) buffer for
        the P·V GEMM, ``mask`` an optional ``(i, j) -> bool-expr``
        invalidating scores before the rescale.
        """
        neg_inf = -T.infinity(self.accum_dtype)
        if mask is not None:
            for i, j in T.Parallel(self.rows, cols):
                acc_s[i, j] = T.if_then_else(mask(i, j), acc_s[i, j], neg_inf)
        T.copy(self.scores_max, self.scores_max_prev)
        if not self.running_max:
            T.fill(self.scores_max, neg_inf)
        T.reduce_max(acc_s, self.scores_max, dim=1, clear=False)
        for i in T.Parallel(self.rows):
            self.scores_scale[i] = T.exp2(
                T.maximum(self.scores_max_prev[i], NEG_CLAMP) * self.scale
                - self._cur(i) * self.scale
            )
        for i, j in T.Parallel(self.rows, cols):
            acc_s[i, j] = T.exp2(acc_s[i, j] * self.scale - self._cur(i) * self.scale)
        T.reduce_sum(acc_s, self.scores_sum, dim=1)
        probs = acc_s
        if self.shared_scores is not None:
            T.copy(acc_s, self.shared_scores)
            probs = self.shared_scores
        for i in T.Parallel(self.rows):
            self.logsum[i] = self.logsum[i] * self.scores_scale[i] + self.scores_sum[i]
        for i, j in T.Parallel(self.rows, self.v_dim):
            self.acc_o[i, j] = self.acc_o[i, j] * self.scores_scale[i]
        T.gemm(probs, v_source, self.acc_o)

    def finalize(self, out_region):
        """Normalize by the log-sum and store to ``out_region``."""
        for i, j in T.Parallel(self.rows, self.v_dim):
            den = T.maximum(self.logsum[i], 1e-30) if self.safe_div else self.logsum[i]
            self.acc_o[i, j] = self.acc_o[i, j] / den
        T.copy(self.acc_o, out_region)


# Packed KV storage: values per int8 byte, per format (the KV-cache subset
# of dequant_matmul's _PACK — nf4/int2 stay weight-only; see DESIGN.md §5.6).
KV_PACK = {"int8": 1, "int4": 2}


class DequantStage:
    """Quantized KV source: the dequant composition point for ``load_kv``.

    Stages a packed int8 tile plus its per-row scales into shared memory,
    unpacks with the shift/mask idiom (dequant_matmul.py's
    Fig. 15/17 fast-dequant loop lifted to the KV path), applies the scales,
    and lands the compute-dtype tile in a shared buffer ready for the GEMM —
    so a quantized paged kernel differs from its fp twin only by routing
    ``load_kv`` through :meth:`load` instead of a plain ``T.copy``.

    The packed bytes and scales stay resident in ``packed_shared`` /
    ``scale_shared`` after a load: the prefill kernels re-copy those slices
    straight into the page pools through :meth:`packed_rows` (write path
    stores what was read, no re-quantization).

    The local unpack staging is *vector-padded*: ``packed_shared`` is a
    window (its block shape must mirror the global page layout), but
    ``packed_local`` is local scratch, whose rows are rounded up to whole
    16-byte vectors (layout.py's ``VECTOR_BYTES``; the JAX package rounds
    to the TPU's 128 lanes).  The staging copy fills only the live
    ``[0:cols]`` columns, and the whole scratch is zeroed once at allocation,
    padded or not (shared memory on the card starts undefined), so no
    backend ever reads an uninitialized byte of it whatever later passes do
    with the buffer.
    """

    def __init__(self, rows, feat, fmt, dtype="float32"):
        if fmt not in KV_PACK:
            raise ValueError(f"unsupported KV quant format {fmt}")
        self.rows, self.feat, self.fmt, self.dtype = rows, feat, fmt, dtype
        self.pack = KV_PACK[fmt]
        if feat % self.pack:
            raise ValueError("feature dim must be a multiple of the pack factor")
        self.cols = feat // self.pack  # live packed columns
        vec = vector_elems("int8")
        padded = -(-self.cols // vec) * vec
        self.packed_shared = T.alloc_shared((rows, self.cols), "int8")
        self.packed_local = T.alloc_fragment((rows, padded), "int8")
        self.scale_shared = T.alloc_shared((rows, 1), dtype)
        self.deq = T.alloc_fragment((rows, feat), dtype)
        self.out = T.alloc_shared((rows, feat), dtype)
        T.clear(self.packed_local)

    def packed_rows(self, r0, r1):
        """The live packed columns of rows ``[r0:r1]`` of the staged bytes —
        what the prefill write-back copies into the page pool."""
        return self.packed_shared[r0:r1, 0:self.cols]

    def load(self, packed_region, scale_region):
        """Stage one packed tile + scales and return the dequantized tile."""
        T.copy(packed_region, self.packed_shared)
        T.copy(scale_region, self.scale_shared)
        return self.dequant()

    def dequant(self):
        """Unpack + scale whatever is staged in ``packed_shared``."""
        T.copy(self.packed_shared,
               self.packed_local[0 : self.rows, 0 : self.cols])
        if self.fmt == "int4":
            for i, j in T.Parallel(self.rows, self.feat):
                v = (self.packed_local[i, j // 2] >> ((j % 2) * 4)) & 15
                v = T.if_then_else(v >= 8, v - 16, v)
                self.deq[i, j] = T.cast(v, self.dtype)
        else:  # int8: straight cast
            for i, j in T.Parallel(self.rows, self.feat):
                self.deq[i, j] = T.cast(self.packed_local[i, j], self.dtype)
        for i, j in T.Parallel(self.rows, self.feat):
            self.deq[i, j] = self.deq[i, j] * self.scale_shared[i, 0]
        T.copy(self.deq, self.out)
        return self.out


def scores(acc_s, q, k, extra=()):
    """Fill ``acc_s`` with Q·Kᵀ — the Q-packing composition point.

    ``extra`` is further ``(q_part, k_part)`` pairs accumulated into the
    same tile: MLA's rope split scores ``q·kvᵀ + q_pe·k_peᵀ`` in one call.
    """
    T.clear(acc_s)
    T.gemm(q, k, acc_s, transpose_B=True)
    for qe, ke in extra:
        T.gemm(qe, ke, acc_s, transpose_B=True)


def attend(ons, acc_s, cols, extent, load_kv, score, mask=None, num_stages=2):
    """One pipelined online-softmax pass over ``extent`` KV tiles.

    ``load_kv(k)`` stages step ``k``'s tiles and returns ``(k_src, v_src)``
    (the KV-source composition point — contiguous window or block-table
    page gather); ``score(acc_s, k_src, k)`` fills the score tile;
    ``mask(k)`` returns the step's ``(i, j)`` mask (or None).
    """
    for k in T.Pipelined(extent, num_stages=num_stages):
        k_src, v_src = load_kv(k)
        score(acc_s, k_src, k)
        ons.update(acc_s, cols, v_src, None if mask is None else mask(k))


# ---------------------------------------------------------------------------
# Mask factories (compose with &)
# ---------------------------------------------------------------------------


def causal(q_pos, k_pos):
    """Key at ``k_pos(j)`` visible to query at ``q_pos(i)`` iff not future."""
    return lambda i, j: q_pos(i) >= k_pos(j)


def ragged(length, k_pos, window=None):
    """Live keys are ``[max(0, length - window), length)`` — decode masks
    for per-slot lengths (table padding / partial pages contribute nothing)."""
    def mask(i, j):
        valid = k_pos(j) < length
        if window is not None:
            valid = valid & (k_pos(j) >= (length - window))
        return valid
    return mask


def banded(q_pos, k_pos, window):
    """Sliding window: key within ``window`` positions behind the query."""
    return lambda i, j: (q_pos(i) - k_pos(j)) < window


def both(a, b):
    """Conjunction of two masks (None = unconstrained)."""
    if a is None:
        return b
    if b is None:
        return a
    return lambda i, j: a(i, j) & b(i, j)


def _executable_lines(src: str) -> set:
    """Line numbers carrying executable tokens — comments and docstrings
    excluded, matching what ``TileProgram.source_lines`` measures for the
    (docstring-free) kernel bodies."""
    import io
    import tokenize

    skip = {tokenize.COMMENT, tokenize.STRING, tokenize.NL, tokenize.NEWLINE,
            tokenize.INDENT, tokenize.DEDENT, tokenize.ENCODING,
            tokenize.ENDMARKER}
    lines = set()
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type not in skip:
            lines.add(tok.start[0])
    return lines


def source_lines() -> int:
    """Executable source lines of the online-softmax template.  bench_loc
    counts the template once against the pre-refactor sum of the
    hand-rolled softmax loops.  :class:`DequantStage` is excluded — it is
    the *quantized* kernels' composition point, charged separately
    (:func:`dequant_stage_lines`) against the four quantized variants."""
    import inspect

    mod_src, mod_start = inspect.getsource(inspect.getmodule(source_lines)), 1
    lines = _executable_lines(mod_src)
    dq_src, dq_start = inspect.getsourcelines(DequantStage)
    dq_range = set(range(dq_start, dq_start + len(dq_src)))
    return len(lines - dq_range)


def dequant_stage_lines() -> int:
    """Executable source lines of :class:`DequantStage` alone — the dequant
    KV-source composition point shared by the quantized paged / prefill /
    MLA kernels (and written once instead of four unpack loops)."""
    import inspect

    src, start = inspect.getsourcelines(DequantStage)
    return len(_executable_lines("".join(src)))
