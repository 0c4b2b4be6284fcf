/* Native CABAC finalizer: byte-exact VVC binary arithmetic encoder.
 *
 * Mirrors codec/cabac.py BinEncoder (itself byte-exact vs VTM-10.0
 * BinEncoder.cpp): the Python side records the slice-data bin-op stream
 * (RecordingEncoder) and hands the whole stream to cabac_run(), which
 * plays it through the arithmetic coder, terminates the slice
 * (end_of_slice_one_bit + finish + rbsp stop bit + byte alignment) and
 * returns the payload bytes.  This is the "host finalize" half of the
 * TPU entropy design (SURVEY.md section 7.4): the parallel coding pass
 * produces (kind, value, ctx) streams; this native stage serializes.
 *
 * op kinds: 0 = context bin (a=bin, b=ctxId)
 *           1 = EP bin      (a=bin)
 *           2 = EP bins     (a=bins, b=numBins)
 *           3 = remAbsEP    (a=value, b=ricePar, c=cutoff, d=maxLog2)
 *
 * Build: cc -O2 -shared -fPIC cabac.c -o libcabac.so
 */
#include <stdint.h>

#define MASK_0 (((1u << 10) - 1) << 5)
#define MASK_1 (((1u << 14) - 1) << 1)

static const int renorm_table[32] = {
    6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

typedef struct {
    uint64_t low;
    int32_t range;
    int bits_left;
    int num_buffered;
    uint32_t buffered_byte;
    uint8_t *out;
    long pos, cap;
    uint64_t held_val;
    int held_bits;
    int overflow;
} Enc;

static void put_byte(Enc *e, uint8_t b)
{
    if (e->pos >= e->cap) { e->overflow = 1; return; }
    e->out[e->pos++] = b;
}

static void write_out(Enc *e)
{
    uint32_t lead = (uint32_t)(e->low >> (24 - e->bits_left));
    e->bits_left += 8;
    e->low &= 0xFFFFFFFFull >> e->bits_left;
    if (lead == 0xFFu) {
        e->num_buffered += 1;
    } else if (e->num_buffered > 0) {
        uint32_t carry = lead >> 8;
        put_byte(e, (uint8_t)((e->buffered_byte + carry) & 0xFF));
        e->buffered_byte = lead & 0xFF;
        uint8_t fill = (uint8_t)((0xFF + carry) & 0xFF);
        while (e->num_buffered > 1) {
            put_byte(e, fill);
            e->num_buffered -= 1;
        }
    } else {
        e->num_buffered = 1;
        e->buffered_byte = lead & 0xFF;
    }
}

static void encode_bin(Enc *e, int bin, int ctx,
                       int32_t *s0a, int32_t *s1a, const int32_t *rate)
{
    int32_t s0 = s0a[ctx], s1 = s1a[ctx];
    uint32_t q = (uint32_t)(s0 + s1) >> 8;
    uint32_t qa = (q & 0x80) ? (q ^ 0xFF) : q;
    int32_t lps = (int32_t)(((qa >> 2) * ((uint32_t)e->range >> 5) >> 1) + 4);
    e->range -= lps;
    if (bin != (int)(q >> 7)) {
        int nb = renorm_table[lps >> 3];
        e->bits_left -= nb;
        e->low = (e->low + (uint32_t)e->range) << nb;
        e->range = lps << nb;
        if (e->bits_left < 12) write_out(e);
    } else if (e->range < 256) {
        e->bits_left -= 1;
        e->low <<= 1;
        e->range <<= 1;
        if (e->bits_left < 12) write_out(e);
    }
    int r0 = rate[ctx] >> 4, r1 = rate[ctx] & 15;
    s0 -= (s0 >> r0) & (int32_t)MASK_0;
    s1 -= (s1 >> r1) & (int32_t)MASK_1;
    if (bin) {
        s0 += (0x7FFF >> r0) & (int32_t)MASK_0;
        s1 += (0x7FFF >> r1) & (int32_t)MASK_1;
    }
    s0a[ctx] = s0;
    s1a[ctx] = s1;
}

static void encode_aligned_bins_ep(Enc *e, uint64_t bins, int num)
{
    int rem = num;
    while (rem > 0) {
        int n = rem < 8 ? rem : 8;
        uint64_t nb = (bins >> (rem - n)) & ((1u << n) - 1);
        e->low = (e->low << n) + (nb << 8);
        rem -= n;
        e->bits_left -= n;
        if (e->bits_left < 12) write_out(e);
    }
}

static void encode_bins_ep(Enc *e, uint64_t bins, int num)
{
    if (e->range == 256) {
        encode_aligned_bins_ep(e, bins, num);
        return;
    }
    while (num > 8) {
        num -= 8;
        uint64_t pattern = bins >> num;
        e->low = (e->low << 8) + (uint64_t)e->range * pattern;
        bins -= pattern << num;
        e->bits_left -= 8;
        if (e->bits_left < 12) write_out(e);
    }
    e->low = (e->low << num) + (uint64_t)e->range * bins;
    e->bits_left -= num;
    if (e->bits_left < 12) write_out(e);
}

static void encode_bin_ep(Enc *e, int bin)
{
    e->bits_left -= 1;
    e->low <<= 1;
    if (bin) e->low += (uint32_t)e->range;
    if (e->bits_left < 12) write_out(e);
}

static void encode_rem_abs_ep(Enc *e, int64_t value, int rice, int cutoff,
                              int max_log2)
{
    int64_t threshold = (int64_t)cutoff << rice;
    if (value < threshold) {
        int length = (int)(value >> rice) + 1;
        encode_bins_ep(e, (1ull << length) - 2, length);
        encode_bins_ep(e, (uint64_t)(value & ((1ll << rice) - 1)), rice);
    } else {
        int max_prefix = 32 - cutoff - max_log2;
        int64_t code_value = (value >> rice) - cutoff;
        int prefix_len, suffix_len;
        if (code_value >= (1ll << max_prefix) - 1) {
            prefix_len = max_prefix;
            suffix_len = max_log2;
        } else {
            prefix_len = 0;
            while (code_value > (2ll << prefix_len) - 2) prefix_len++;
            suffix_len = prefix_len + rice + 1;
        }
        int total_prefix = prefix_len + cutoff;
        uint64_t prefix = (1ull << total_prefix) - 1;
        uint64_t suffix =
            (uint64_t)(((code_value - ((1ll << prefix_len) - 1)) << rice)
                       | (value & ((1ll << rice) - 1)));
        encode_bins_ep(e, prefix, total_prefix);
        encode_bins_ep(e, suffix, suffix_len);
    }
}

static void encode_bin_trm(Enc *e, int bin)
{
    e->range -= 2;
    if (bin) {
        e->low = (e->low + (uint32_t)e->range) << 7;
        e->range = 2 << 7;
        e->bits_left -= 7;
    } else if (e->range >= 256) {
        return;
    } else {
        e->low <<= 1;
        e->range <<= 1;
        e->bits_left -= 1;
    }
    if (e->bits_left < 12) write_out(e);
}

static void bit_write(Enc *e, uint32_t val, int nbits)
{
    e->held_val = (e->held_val << nbits) | (val & ((1u << nbits) - 1));
    e->held_bits += nbits;
    while (e->held_bits >= 8) {
        e->held_bits -= 8;
        put_byte(e, (uint8_t)((e->held_val >> e->held_bits) & 0xFF));
    }
    e->held_val &= (1u << e->held_bits) - 1;
}

long cabac_run(const int8_t *kind, const int64_t *a, const int32_t *b,
               const int32_t *c, const int32_t *d, long n_ops,
               int32_t *state0, int32_t *state1, const int32_t *rate,
               uint8_t *out, long out_cap)
{
    Enc e = {0};
    e.range = 510;
    e.buffered_byte = 0xFF;
    e.bits_left = 23;
    e.out = out;
    e.cap = out_cap;

    for (long i = 0; i < n_ops; i++) {
        switch (kind[i]) {
        case 0: encode_bin(&e, (int)a[i], b[i], state0, state1, rate); break;
        case 1: encode_bin_ep(&e, (int)a[i]); break;
        case 2: encode_bins_ep(&e, (uint64_t)a[i], b[i]); break;
        case 3: encode_rem_abs_ep(&e, a[i], b[i], c[i], d[i]); break;
        }
        if (e.overflow) return -1;
    }
    /* end_of_slice_one_bit, finish, stop bit + alignment */
    encode_bin_trm(&e, 1);
    if (e.low >> (32 - e.bits_left)) {
        put_byte(&e, (uint8_t)((e.buffered_byte + 1) & 0xFF));
        while (e.num_buffered > 1) {
            put_byte(&e, 0x00);
            e.num_buffered -= 1;
        }
        e.low -= 1ull << (32 - e.bits_left);
    } else {
        if (e.num_buffered > 0) put_byte(&e, (uint8_t)e.buffered_byte);
        while (e.num_buffered > 1) {
            put_byte(&e, 0xFF);
            e.num_buffered -= 1;
        }
    }
    int nbits = 24 - e.bits_left;
    bit_write(&e, nbits ? (uint32_t)((e.low >> 8) & ((1u << nbits) - 1)) : 0,
              nbits);
    bit_write(&e, 1, 1);                         /* rbsp_stop_one_bit */
    if (e.held_bits) bit_write(&e, 0, 8 - e.held_bits);
    if (e.overflow) return -1;
    return e.pos;
}
