// XTC (GROMACS compressed trajectory) encoder.
//
// Writes the 3dfcoord integer compression scheme of the xdrfile format
// specification (magic 1995): coordinates are quantised by a precision
// factor, stored as big-endian XDR with absolute triples packed by a
// mixed-radix big-number code and runs of small deltas.  The encoder
// half of the port's codec (spinrelax_tpu_torch/csrc/xtc.cpp), copied
// unchanged; the benchmark writes its trajectories with it.
//
// Exposed through the plain C ABI (ctypes).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int MAGIC = 1995;
const int FIRSTIDX = 9;

// The exact published xdrfile table, historical quirks included (5060
// rather than the mathematical 5160, 524287 = 2^19-1, 8388607 = 2^23-1):
// every conforming implementation must carry these verbatim or its
// small-run word sizes disagree with files in the wild.
const int magicints[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216};
const int LASTIDX = (int)(sizeof(magicints) / sizeof(int)) - 1;

// ---------------------------------------------------------------- XDR IO

struct Writer {
    FILE* fp;
    bool ok = true;  // sticky: any failed fwrite (e.g. ENOSPC) latches

    void u32(uint32_t v) {
        unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                              (unsigned char)(v >> 8), (unsigned char)v};
        if (fwrite(b, 1, 4, fp) != 4) ok = false;
    }
    void i32(int32_t v) { u32((uint32_t)v); }
    void f32(float f) {
        uint32_t u;
        memcpy(&u, &f, 4);
        u32(u);
    }
    void bytes(const unsigned char* src, size_t n) {
        if (fwrite(src, 1, n, fp) != n) ok = false;
    }
};

// ------------------------------------------------------------- bit codec

struct BitBuf {
    std::vector<unsigned char> data;
    int lastbits = 0;         // bits held in lastbyte
    uint32_t lastbyte = 0;
};

static void encodebits(BitBuf& buf, int num_of_bits, uint32_t num) {
    uint32_t lastbyte = buf.lastbyte;
    int lastbits = buf.lastbits;
    while (num_of_bits >= 8) {
        lastbyte = (lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xff);
        buf.data.push_back((unsigned char)(lastbyte >> lastbits));
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) {
        lastbyte = (lastbyte << num_of_bits) | (num & ((1u << num_of_bits) - 1));
        lastbits += num_of_bits;
        if (lastbits >= 8) {
            lastbits -= 8;
            buf.data.push_back((unsigned char)(lastbyte >> lastbits));
        }
    }
    buf.lastbits = lastbits;
    buf.lastbyte = lastbyte;
}

static void flushbits(BitBuf& buf) {
    if (buf.lastbits > 0) {
        buf.data.push_back((unsigned char)(buf.lastbyte << (8 - buf.lastbits)));
        buf.lastbits = 0;
        buf.lastbyte = 0;
    }
}

static int sizeofint(uint32_t size) {
    uint32_t num = 1;
    int num_of_bits = 0;
    while (size >= num && num_of_bits < 32) {
        num_of_bits++;
        num <<= 1;
    }
    return num_of_bits;
}

static int sizeofints(int num_of_ints, const uint32_t sizes[]) {
    uint32_t bytes[32];
    uint32_t num_of_bytes = 1;
    bytes[0] = 1;
    int num_of_bits = 0;
    for (int i = 0; i < num_of_ints; i++) {
        uint32_t tmp = 0;
        uint32_t bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    uint32_t num = 1;
    num_of_bytes--;
    while (bytes[num_of_bytes] >= num) {
        num_of_bits++;
        num *= 2;
    }
    return num_of_bits + (int)num_of_bytes * 8;
}

static void encodeints(BitBuf& buf, int num_of_ints, int num_of_bits,
                       const uint32_t sizes[], const uint32_t nums[]) {
    uint32_t bytes[32];
    int num_of_bytes = 0;
    uint32_t tmp = nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < num_of_ints; i++) {
        // bignum = bignum * sizes[i] + nums[i]
        tmp = nums[i];
        int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
        for (int i = 0; i < num_of_bytes; i++) encodebits(buf, 8, bytes[i]);
        encodebits(buf, num_of_bits - num_of_bytes * 8, 0);
    } else {
        int i;
        for (i = 0; i < num_of_bytes - 1; i++) encodebits(buf, 8, bytes[i]);
        encodebits(buf, num_of_bits - (num_of_bytes - 1) * 8, bytes[i]);
    }
}

// ------------------------------------------------------- frame handling

static void write_frame(Writer& wr, int natoms, int step, float time,
                        const float* box9, const float* xyz, float precision) {
    wr.i32(MAGIC);
    wr.i32(natoms);
    wr.i32(step);
    wr.f32(time);
    for (int i = 0; i < 9; i++) wr.f32(box9 ? box9[i] : 0.0f);
    wr.i32(natoms);
    if (natoms <= 9) {
        for (int i = 0; i < natoms * 3; i++) wr.f32(xyz[i]);
        return;
    }
    wr.f32(precision);

    std::vector<int32_t> ip(natoms * 3);
    int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    for (int a = 0; a < natoms; a++) {
        for (int d = 0; d < 3; d++) {
            float f = xyz[a * 3 + d] * precision;
            // Quantisation overflow (stray coordinate, NaN, precision
            // too high) is int32-cast UB that would encode a silently
            // corrupt frame; xdrfile errors here ('scaling will cause
            // overflow') and so do we.
            if (!(f > -2.0e9f && f < 2.0e9f)) { wr.ok = false; return; }
            int32_t v = (int32_t)(f >= 0 ? f + 0.5f : f - 0.5f);
            ip[a * 3 + d] = v;
            if (v < minint[d]) minint[d] = v;
            if (v > maxint[d]) maxint[d] = v;
        }
    }
    for (int d = 0; d < 3; d++) wr.i32(minint[d]);
    for (int d = 0; d < 3; d++) wr.i32(maxint[d]);

    uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++) sizeint[d] = (uint32_t)(maxint[d] - minint[d] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        for (int d = 0; d < 3; d++) bitsizeint[d] = sizeofint(sizeint[d]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    // Fixed small word size (valid, non-adaptive encoder: is_smaller == 0
    // always, encoded as run = 3*n + 1).
    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX - 1 && magicints[smallidx] < 1024) smallidx++;
    int small = magicints[smallidx] / 2;
    uint32_t sizesmall[3] = {(uint32_t)magicints[smallidx],
                             (uint32_t)magicints[smallidx],
                             (uint32_t)magicints[smallidx]};
    wr.i32(smallidx);

    auto fits_small = [&](const int32_t* d) {
        for (int k = 0; k < 3; k++)
            if (d[k] + small < 0 || (uint32_t)(d[k] + small) >= sizesmall[0])
                return false;
        return true;
    };

    BitBuf buf;
    int i = 0;
    int prevrun = 0;  // decoder starts with run = 0; only CHANGES are
                      // signalled (canonical 3dfcoord: flag=0 reuses it)
    while (i < natoms) {
        // Absolute atom: the decoder's run path outputs [delta-atom,
        // absolute-atom, ...], so when we have >= 2 atoms whose first
        // delta is small we emit atom i+1 as the absolute and atom i as
        // the first run element.
        int32_t d01[3];
        bool can_run = false;
        if (i + 1 < natoms) {
            for (int k = 0; k < 3; k++)
                d01[k] = ip[i * 3 + k] - ip[(i + 1) * 3 + k];
            can_run = fits_small(d01);
        }
        if (!can_run) {
            uint32_t abs3[3];
            for (int k = 0; k < 3; k++)
                abs3[k] = (uint32_t)(ip[i * 3 + k] - minint[k]);
            if (bitsize == 0) {
                for (int k = 0; k < 3; k++) encodebits(buf, bitsizeint[k], abs3[k]);
            } else {
                encodeints(buf, 3, bitsize, sizeint, abs3);
            }
            if (prevrun != 0) {
                encodebits(buf, 1, 1);
                encodebits(buf, 5, 1);  // run = 0, is_smaller = 0
                prevrun = 0;
            } else {
                encodebits(buf, 1, 0);  // run length unchanged (still 0)
            }
            i++;
            continue;
        }
        // Build a run: decoder output order is [y0(=atom i), y1(=atom i+1,
        // absolute), y2(=atom i+2), ...]; deltas chain y0 off y1, y2 off
        // y0, then consecutive.
        int max_run_atoms = 10;  // run field = 3*n + 1 <= 31
        int n = 1;               // number of run (delta) atoms; starts with y0
        
        // Count further atoms whose chained delta stays small.
        {
            int32_t prev[3] = {ip[i * 3 + 0], ip[i * 3 + 1], ip[i * 3 + 2]};  // y0
            for (int j = i + 2; j < natoms && n < max_run_atoms; j++) {
                int32_t d[3] = {ip[j * 3 + 0] - prev[0], ip[j * 3 + 1] - prev[1],
                                ip[j * 3 + 2] - prev[2]};
                if (!fits_small(d)) break;
                n++;
                prev[0] = ip[j * 3 + 0];
                prev[1] = ip[j * 3 + 1];
                prev[2] = ip[j * 3 + 2];
            }
        }
        // Emit absolute y1 = atom i+1.
        uint32_t abs3[3];
        for (int k = 0; k < 3; k++)
            abs3[k] = (uint32_t)(ip[(i + 1) * 3 + k] - minint[k]);
        if (bitsize == 0) {
            for (int k = 0; k < 3; k++) encodebits(buf, bitsizeint[k], abs3[k]);
        } else {
            encodeints(buf, 3, bitsize, sizeint, abs3);
        }
        if (3 * n != prevrun) {
            encodebits(buf, 1, 1);
            encodebits(buf, 5, (uint32_t)(3 * n + 1));  // is_smaller = 0
            prevrun = 3 * n;
        } else {
            encodebits(buf, 1, 0);  // same run length as previous block
        }
        // First delta: y0 relative to y1.
        uint32_t enc[3];
        for (int k = 0; k < 3; k++) enc[k] = (uint32_t)(d01[k] + small);
        encodeints(buf, 3, smallidx, sizesmall, enc);
        // Remaining deltas: y_{m+1} (atom i+m+1) chains off previous run
        // element (y0 for the first, then consecutive).
        int32_t prev[3] = {ip[i * 3 + 0], ip[i * 3 + 1], ip[i * 3 + 2]};
        for (int m = 1; m < n; m++) {
            int j = i + 1 + m;  // atom index of y_{m+1}
            int32_t d[3] = {ip[j * 3 + 0] - prev[0], ip[j * 3 + 1] - prev[1],
                            ip[j * 3 + 2] - prev[2]};
            for (int k = 0; k < 3; k++) enc[k] = (uint32_t)(d[k] + small);
            encodeints(buf, 3, smallidx, sizesmall, enc);
            prev[0] = ip[j * 3 + 0];
            prev[1] = ip[j * 3 + 1];
            prev[2] = ip[j * 3 + 2];
        }
        i += n + 1;
    }
    flushbits(buf);
    wr.i32((int32_t)buf.data.size());
    size_t padded = (buf.data.size() + 3) / 4 * 4;
    buf.data.resize(padded, 0);
    wr.bytes(buf.data.data(), padded);
}

}  // namespace

extern "C" {

// Write n_frames frames of natoms atoms; 0, or -1 (open) / -2 (I/O or
// quantisation overflow).
int xtc_write(const char* path, const float* xyz, const float* times,
              const float* boxes, long n_frames, int natoms, float precision) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return -1;
    Writer wr{fp};
    for (long f = 0; f < n_frames && wr.ok; f++) {
        write_frame(wr, natoms, (int)f, times ? times[f] : (float)f,
                    boxes ? boxes + (size_t)f * 9 : nullptr,
                    xyz + (size_t)f * natoms * 3, precision);
    }
    int rc = fclose(fp);
    return (wr.ok && rc == 0) ? 0 : -2;  // I/O failure or overflow
}
}
