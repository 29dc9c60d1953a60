"""Reference-parity contracts pinned verbatim.

Two cheap, permanent locks against /root/reference:

1. The hard-coded evaluation-order table ``k_wntt_exp[512]`` (HE.cu:72-105)
   asserted literal-for-literal against the derivation in
   ``config.GLParams.w_exponents`` (config.py:160-175).

2. A POLY_N=32768 bit-exact NTT roundtrip driver shaped after
   ``test/phantom_ntt_roundtrip.cu``: the [tower][coeff] layout, the
   deterministic xorshift fill (phantom_ntt_roundtrip.cu:32-51), L=11 towers,
   forward+backward through the production large-N path, exact u64 compare
   (phantom_ntt_roundtrip.cu:138-160).

Note on moduli: the reference driver reuses RNS_MODULI, which are only
== 1 (mod 256) (config.h:27-31) -- a negacyclic length-32768 NTT needs
q == 1 (mod 2^16), so that driver is stale/broken upstream (it exit(1)s in
the GL build; SURVEY.md par.4).  We honor the *contract* (bit-exact roundtrip
at POLY_N with 11 towers and the exact same fill stream) with primes of the
same 35-bit width that satisfy the root condition.
"""

import numpy as np
import jax.numpy as jnp

from matrix_fhe.config import get_params
from matrix_fhe.ops.ntt_large import FourStepNTT, FourStepPlan, generate_primes_1mod

# Verbatim from /root/reference/src/core/HE.cu:72-105 (the parameter set's
# evaluation order IS these constants; category-b unavoidable similarity).
K_WNTT_EXP = (
    260, 263, 266, 269, 272, 275, 278, 281, 284, 287, 290, 293, 296, 299, 302, 305,
    308, 311, 314, 317, 320, 323, 326, 329, 332, 335, 338, 341, 344, 347, 350, 353,
    356, 359, 362, 365, 368, 371, 374, 377, 380, 383, 386, 389, 392, 395, 398, 401,
    404, 407, 410, 413, 416, 419, 422, 425, 428, 431, 434, 437, 440, 443, 446, 449,
    452, 455, 458, 461, 464, 467, 470, 473, 476, 479, 482, 485, 488, 491, 494, 497,
    500, 503, 506, 509, 512, 515, 518, 521, 524, 527, 530, 533, 536, 539, 542, 545,
    548, 551, 554, 557, 560, 563, 566, 569, 572, 575, 578, 581, 584, 587, 590, 593,
    596, 599, 602, 605, 608, 611, 614, 617, 620, 623, 626, 629, 632, 635, 638, 641,
    644, 647, 650, 653, 656, 659, 662, 665, 668, 671, 674, 677, 680, 683, 686, 689,
    692, 695, 698, 701, 704, 707, 710, 713, 716, 719, 722, 725, 728, 731, 734, 737,
    740, 743, 746, 749, 752, 755, 758, 761, 764, 767, 770, 2, 5, 8, 11, 14,
    17, 20, 23, 26, 29, 32, 35, 38, 41, 44, 47, 50, 53, 56, 59, 62,
    65, 68, 71, 74, 77, 80, 83, 86, 89, 92, 95, 98, 101, 104, 107, 110,
    113, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 176, 179, 182, 185, 188, 191, 194, 197, 200, 203, 206,
    209, 212, 215, 218, 221, 224, 227, 230, 233, 236, 239, 242, 245, 248, 251, 254,
    517, 520, 523, 526, 529, 532, 535, 538, 541, 544, 547, 550, 553, 556, 559, 562,
    565, 568, 571, 574, 577, 580, 583, 586, 589, 592, 595, 598, 601, 604, 607, 610,
    613, 616, 619, 622, 625, 628, 631, 634, 637, 640, 643, 646, 649, 652, 655, 658,
    661, 664, 667, 670, 673, 676, 679, 682, 685, 688, 691, 694, 697, 700, 703, 706,
    709, 712, 715, 718, 721, 724, 727, 730, 733, 736, 739, 742, 745, 748, 751, 754,
    757, 760, 763, 766, 769, 1, 4, 7, 10, 13, 16, 19, 22, 25, 28, 31,
    34, 37, 40, 43, 46, 49, 52, 55, 58, 61, 64, 67, 70, 73, 76, 79,
    82, 85, 88, 91, 94, 97, 100, 103, 106, 109, 112, 115, 118, 121, 124, 127,
    130, 133, 136, 139, 142, 145, 148, 151, 154, 157, 160, 163, 166, 169, 172, 175,
    178, 181, 184, 187, 190, 193, 196, 199, 202, 205, 208, 211, 214, 217, 220, 223,
    226, 229, 232, 235, 238, 241, 244, 247, 250, 253, 256, 259, 262, 265, 268, 271,
    274, 277, 280, 283, 286, 289, 292, 295, 298, 301, 304, 307, 310, 313, 316, 319,
    322, 325, 328, 331, 334, 337, 340, 343, 346, 349, 352, 355, 358, 361, 364, 367,
    370, 373, 376, 379, 382, 385, 388, 391, 394, 397, 400, 403, 406, 409, 412, 415,
    418, 421, 424, 427, 430, 433, 436, 439, 442, 445, 448, 451, 454, 457, 460, 463,
    466, 469, 472, 475, 478, 481, 484, 487, 490, 493, 496, 499, 502, 505, 508, 511,
)



def test_k_wntt_exp_table_verbatim():
    """config.w_exponents must reproduce all 512 hard-coded literals."""
    assert len(K_WNTT_EXP) == 512
    derived = get_params("ref").w_exponents
    assert tuple(derived) == K_WNTT_EXP


def _phantom_fill(total_len: int, n: int, moduli) -> np.ndarray:
    """The reference driver's deterministic xorshift fill, bit-for-bit
    (phantom_ntt_roundtrip.cu:32-51): per-index xorshift on
    0x9E3779B97F4A7C15 ^ idx, reduced mod the tower's modulus."""
    idx = np.arange(total_len, dtype=np.uint64)
    x = np.uint64(0x9E3779B97F4A7C15) ^ idx
    x ^= x >> np.uint64(12)
    x ^= x << np.uint64(25)
    x ^= x >> np.uint64(27)
    x *= np.uint64(2685821657736338717)
    q = np.repeat(np.asarray(moduli, dtype=np.uint64), n)
    return x % q


def test_phantom_ntt_roundtrip_poly_n():
    """Bit-exact forward+backward at POLY_N=32768, 11 towers, exact compare."""
    params = get_params("ref")
    poly_n = params.pack_n          # POLY_N = 32768 (config.h:17)
    L = params.num_limbs            # 11 towers
    moduli = generate_primes_1mod(L, 35, 2 * poly_n)
    x = _phantom_fill(L * poly_n, poly_n, moduli).reshape(L, 1, poly_n)
    plan = FourStepPlan.make(poly_n, moduli, negacyclic=True)
    ntt = FourStepNTT(plan)
    fwd = ntt.forward(jnp.asarray(x))
    back = np.asarray(ntt.inverse(fwd))
    assert back.dtype == np.uint64 or back.dtype == np.dtype("uint64")
    assert (back == x).all()
