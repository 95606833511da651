"""The eager random draws' share of their roofline: the least time the
window's drawn words need (:func:`draw_bound_s`, from the program's
``draw_words`` counter) over the device time launched inside its
``repro_torch.random.draws`` span.

The bound is counted from the function, not from any implementation.
Word n of a draw is x0 ^ x1 of threefry2x32 of counter n, so each word
takes one hash: 20 rotations and 21 xors (20 rounds and the output xor)
that only the integer ALU issues, and 27 adds (one a round, the key words
before each of the 5 groups, both words of the last injection) that
either pipe may issue, at the issue rates of :mod:`perfbench.work`. The
words are written once at the draw's dtype (the configuration's
``prob_dtype``: the uniforms the paper pipeline compares). The larger of
the operations and bytes bounds is the bound."""
from perfbench import spans, work

DRAWS = "repro_torch.random.draws"
HASH_INT_ONLY, HASH_ADDS = 20 + 21, 20 + 5 + 2
WORD_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "uint32": 4}


def word_clocks() -> float:
    """SM clocks one word's hash needs at the tighter of the integer ALU
    and issue limits."""
    return max(HASH_INT_ONLY / work.INT_PER_CLOCK,
               (HASH_INT_ONLY + HASH_ADDS) / work.ISSUE_PER_CLOCK)


def draw_bound_s(words: int, word_bytes: int) -> float:
    ops = words * word_clocks() / (work.SM_CLOCK_HZ * work.SMS)
    return max(ops, words * word_bytes / work.HBM_BYTES_PER_S)


def read(w):
    words = w.counters.get("draw_words")
    s = spans.launched_seconds(w, (DRAWS,))
    if not words or not s:
        return None
    nbytes = WORD_BYTES[w.config.get("prob_dtype", "uint32")]
    return 100.0 * draw_bound_s(words, nbytes) / s
