// Fast binary trajectory reading for the host-side data pipeline.
//
// DCD (CHARMM/NAMD/LAMMPS) reader: Fortran-unformatted records with a
// 'CORD' header, optional per-frame 6-double unit cell, and per-frame
// X/Y/Z float records. The reference framework reads trajectories through
// MDAnalysis (tfep/io/dataset/traj.py:43); here frame decoding is native
// so multi-gigabyte trajectories stream into the sharded batch pipeline
// without Python-loop overhead. Exposed through ctypes (no pybind11 in
// this environment); see tfep_tpu_torch/io/dcd.py for the Python surface and a
// pure-Python fallback used when no compiler is available.
//
// Build: g++ -O3 -shared -fPIC -o _trajio.so trajio.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct DcdInfo {
    int64_t n_frames;
    int64_t n_atoms;
    int64_t has_cell;
    int64_t first_frame_offset;
    int64_t frame_size_bytes;
};

// Read a 4-byte record marker; returns -1 on EOF/error.
int64_t read_marker(std::FILE* f) {
    uint32_t marker;
    if (std::fread(&marker, 4, 1, f) != 1) return -1;
    return static_cast<int64_t>(marker);
}

bool parse_header(std::FILE* f, DcdInfo* info) {
    int64_t marker = read_marker(f);
    if (marker != 84) return false;

    char magic[4];
    if (std::fread(magic, 1, 4, f) != 4) return false;
    if (std::memcmp(magic, "CORD", 4) != 0) return false;

    int32_t icntrl[20];
    if (std::fread(icntrl, 4, 20, f) != 20) return false;
    if (read_marker(f) != 84) return false;

    // Fixed-atom DCDs (NAMNF != 0) store only the free atoms for frames
    // after the first; the uniform frame-size assumption below would
    // silently decode garbage. Reject (the Python wrapper re-parses to
    // produce the specific error message).
    if (icntrl[8] != 0) return false;

    int64_t n_frames_header = icntrl[0];
    info->has_cell = (icntrl[10] != 0) ? 1 : 0;

    // Title block: marker, ntitle, 80*ntitle chars, marker.
    int64_t title_marker = read_marker(f);
    if (title_marker < 4) return false;
    if (std::fseek(f, title_marker, SEEK_CUR) != 0) return false;
    if (read_marker(f) != title_marker) return false;

    // Atom-count record.
    if (read_marker(f) != 4) return false;
    int32_t n_atoms;
    if (std::fread(&n_atoms, 4, 1, f) != 1) return false;
    if (read_marker(f) != 4) return false;

    info->n_atoms = n_atoms;
    info->first_frame_offset = std::ftell(f);

    int64_t coord_record = 8 + 4 * static_cast<int64_t>(n_atoms);
    info->frame_size_bytes = 3 * coord_record
        + (info->has_cell ? (8 + 48) : 0);

    // Count frames from the file size (headers sometimes lie).
    std::fseek(f, 0, SEEK_END);
    int64_t file_size = std::ftell(f);
    int64_t data_bytes = file_size - info->first_frame_offset;
    info->n_frames = data_bytes / info->frame_size_bytes;
    if (n_frames_header > 0 && n_frames_header < info->n_frames)
        info->n_frames = n_frames_header;
    return true;
}

}  // namespace

extern "C" {

// Parse the DCD header. Returns 0 on success, negative on error.
// out = [n_frames, n_atoms, has_cell].
int dcd_read_header(const char* path, int64_t* out) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    DcdInfo info;
    bool ok = parse_header(f, &info);
    std::fclose(f);
    if (!ok) return -2;
    out[0] = info.n_frames;
    out[1] = info.n_atoms;
    out[2] = info.has_cell;
    return 0;
}

// Read `n_indices` frames (by frame index) into `positions`
// (n_indices * n_atoms * 3 floats, xyz interleaved per atom) and, when the
// file has a cell, `cells` (n_indices * 6 doubles). Returns 0 on success.
int dcd_read_frames(const char* path, const int64_t* frame_indices,
                    int64_t n_indices, float* positions, double* cells) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    DcdInfo info;
    if (!parse_header(f, &info)) {
        std::fclose(f);
        return -2;
    }

    const int64_t n_atoms = info.n_atoms;
    float* buffer = new float[n_atoms];

    for (int64_t i = 0; i < n_indices; ++i) {
        int64_t frame = frame_indices[i];
        if (frame < 0 || frame >= info.n_frames) {
            delete[] buffer;
            std::fclose(f);
            return -3;
        }
        int64_t offset = info.first_frame_offset
            + frame * info.frame_size_bytes;
        if (std::fseek(f, offset, SEEK_SET) != 0) {
            delete[] buffer;
            std::fclose(f);
            return -4;
        }

        if (info.has_cell) {
            double cell[6];
            if (read_marker(f) != 48
                || std::fread(cell, 8, 6, f) != 6
                || read_marker(f) != 48) {
                delete[] buffer;
                std::fclose(f);
                return -5;
            }
            if (cells) {
                // DCD cell order: A, gamma, B, beta, alpha, C ->
                // [lx, ly, lz, alpha, beta, gamma].
                cells[6 * i + 0] = cell[0];
                cells[6 * i + 1] = cell[2];
                cells[6 * i + 2] = cell[5];
                cells[6 * i + 3] = cell[4];
                cells[6 * i + 4] = cell[3];
                cells[6 * i + 5] = cell[1];
            }
        }

        float* frame_out = positions + i * n_atoms * 3;
        for (int dim = 0; dim < 3; ++dim) {
            int64_t expected = 4 * n_atoms;
            if (read_marker(f) != expected
                || std::fread(buffer, 4, n_atoms, f)
                   != static_cast<size_t>(n_atoms)
                || read_marker(f) != expected) {
                delete[] buffer;
                std::fclose(f);
                return -6;
            }
            for (int64_t a = 0; a < n_atoms; ++a) {
                frame_out[3 * a + dim] = buffer[a];
            }
        }
    }

    delete[] buffer;
    std::fclose(f);
    return 0;
}

}  // extern "C"

// ===========================================================================
// GROMACS XDR formats: XTC (compressed coordinates) and TRR.
//
// Big-endian streams; the XTC "3dfcoord" compression quantizes coordinates
// by a precision factor, encodes each frame's anchor atoms with bounding-box
// bit widths and runs of near-neighbour atoms as delta triples against a
// geometric integer-range ladder. Decoder implemented from the format
// specification; the Python reference codec (tfep_tpu_torch/io/xdr.py) is the
// correctness oracle (cross-tested: Python-encoded files decoded here).
// ===========================================================================

#include <cmath>
#include <cstdlib>

namespace {

const int kMagicInts[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0,
    8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512,
    645, 812, 1024, 1290, 1625, 2048, 2580, 3250, 4096,
    5060, 6501, 8192, 10321, 13003, 16384, 20642, 26007, 32768,
    41285, 52015, 65536, 82570, 104031, 131072, 165140, 208063, 262144,
    330280, 416127, 524287, 660561, 832255, 1048576, 1321122, 1664510,
    2097152, 2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
    10568983, 13316085, 16777216};
const int kFirstIdx = 9;

inline uint32_t be32(const unsigned char* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16)
         | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int32_t be32i(const unsigned char* p) {
    return static_cast<int32_t>(be32(p));
}

inline float be32f(const unsigned char* p) {
    uint32_t bits = be32(p);
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

inline double be64d(const unsigned char* p) {
    uint64_t bits = (uint64_t(be32(p)) << 32) | be32(p + 4);
    double out;
    std::memcpy(&out, &bits, 8);
    return out;
}

inline int bits_for(uint32_t max_value) {
    int bits = 0;
    while (max_value) { ++bits; max_value >>= 1; }
    return bits;
}

// Bits for a mixed-radix triple: bit length of the product, computed in
// byte-wise multiprecision (the product can exceed 64 bits is impossible
// here — 3 * 24-bit radices fit in 72... use long double-free bytes).
int bits_for_triple(const uint32_t sizes[3]) {
    unsigned char bytes[16];
    int n_bytes = 1;
    bytes[0] = 1;
    for (int i = 0; i < 3; ++i) {
        uint64_t carry = 0;
        for (int b = 0; b < n_bytes; ++b) {
            carry += uint64_t(bytes[b]) * sizes[i];
            bytes[b] = carry & 0xFF;
            carry >>= 8;
        }
        while (carry) { bytes[n_bytes++] = carry & 0xFF; carry >>= 8; }
    }
    --n_bytes;
    return bits_for(bytes[n_bytes]) + 8 * n_bytes;
}

// MSB-first bit reader over a frame's compressed payload.
struct BitReader {
    const unsigned char* data;
    int64_t pos;
    uint64_t partial;
    int n_partial;

    explicit BitReader(const unsigned char* d)
        : data(d), pos(0), partial(0), n_partial(0) {}

    uint32_t get(int n_bits) {
        while (n_partial < n_bits) {
            partial = (partial << 8) | data[pos++];
            n_partial += 8;
        }
        n_partial -= n_bits;
        uint32_t value = (partial >> n_partial)
            & (n_bits >= 32 ? 0xFFFFFFFFu : ((1u << n_bits) - 1));
        partial &= (uint64_t(1) << n_partial) - 1;
        return value;
    }

    // Decode one n_bits-wide integer into mixed-radix digits
    // (little-endian bytes first, then remaining high bits).
    void get_mixed(int n_bits, const uint32_t sizes[3], int32_t out[3]) {
        unsigned char bytes[16];
        int n_bytes = 0;
        while (n_bits > 8) { bytes[n_bytes++] = get(8); n_bits -= 8; }
        if (n_bits > 0) bytes[n_bytes++] = get(n_bits);
        for (int i = 2; i > 0; --i) {
            uint32_t rem = 0;
            for (int b = n_bytes - 1; b >= 0; --b) {
                uint32_t acc = (rem << 8) | bytes[b];
                bytes[b] = acc / sizes[i];
                rem = acc % sizes[i];
            }
            out[i] = rem;
        }
        uint32_t low = 0;
        for (int b = n_bytes - 1; b >= 0; --b) low = (low << 8) | bytes[b];
        out[0] = low;
    }
};

// Decompress one frame's coordinate body (after the repeated atom count).
// Returns bytes consumed, or -1 on error.
int64_t xtc_decompress(const unsigned char* body, int64_t n_atoms,
                       float* out_xyz) {
    if (n_atoms <= 9) {
        for (int64_t i = 0; i < n_atoms * 3; ++i)
            out_xyz[i] = be32f(body + 4 * i);
        return 4 * n_atoms * 3;
    }
    float precision = be32f(body);
    int32_t minint[3], maxint[3];
    for (int k = 0; k < 3; ++k) minint[k] = be32i(body + 4 + 4 * k);
    for (int k = 0; k < 3; ++k) maxint[k] = be32i(body + 16 + 4 * k);
    int smallidx = be32i(body + 28);
    int32_t n_bytes = be32i(body + 32);
    const unsigned char* payload = body + 36;

    uint32_t sizeint[3];
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    bool wide = false;
    for (int k = 0; k < 3; ++k) {
        sizeint[k] = uint32_t(maxint[k] - minint[k] + 1);
        if (sizeint[k] > 0xFFFFFF) wide = true;
    }
    if (wide) {
        for (int k = 0; k < 3; ++k) bitsizeint[k] = bits_for(sizeint[k]);
        bitsize = 0;
    } else {
        bitsize = bits_for_triple(sizeint);
    }

    int smaller = kMagicInts[smallidx > kFirstIdx ? smallidx - 1
                                                  : kFirstIdx] / 2;
    int smallnum = kMagicInts[smallidx] / 2;
    uint32_t sizesmall[3] = {uint32_t(kMagicInts[smallidx]),
                             uint32_t(kMagicInts[smallidx]),
                             uint32_t(kMagicInts[smallidx])};

    BitReader reader(payload);
    float inv_precision = 1.0f / precision;
    int run = 0;
    int64_t i = 0;
    int32_t prev[3];
    while (i < n_atoms) {
        int32_t this_c[3];
        if (bitsize == 0) {
            for (int k = 0; k < 3; ++k)
                this_c[k] = int32_t(reader.get(bitsizeint[k]));
        } else {
            reader.get_mixed(bitsize, sizeint, this_c);
        }
        for (int k = 0; k < 3; ++k) {
            this_c[k] += minint[k];
            prev[k] = this_c[k];
        }
        int64_t seed_row = i;
        for (int k = 0; k < 3; ++k)
            out_xyz[3 * i + k] = this_c[k] * inv_precision;
        ++i;

        int is_smaller = 0;
        if (reader.get(1)) {
            int value = reader.get(5);
            is_smaller = value % 3 - 1;
            run = value - (is_smaller + 1);
        }
        for (int k = 0; k < run; k += 3) {
            int32_t delta[3];
            reader.get_mixed(smallidx, sizesmall, delta);
            for (int d = 0; d < 3; ++d)
                this_c[d] = delta[d] + prev[d] - smallnum;
            if (k == 0) {
                // The run's first atom was swapped in front of its seed.
                for (int d = 0; d < 3; ++d) {
                    out_xyz[3 * seed_row + d] = this_c[d] * inv_precision;
                    out_xyz[3 * i + d] = prev[d] * inv_precision;
                    prev[d] = this_c[d];
                }
            } else {
                for (int d = 0; d < 3; ++d) {
                    out_xyz[3 * i + d] = this_c[d] * inv_precision;
                    prev[d] = this_c[d];
                }
            }
            ++i;
        }

        if (is_smaller < 0) {
            --smallidx;
            smallnum = smaller;
            smaller = smallidx > kFirstIdx ? kMagicInts[smallidx - 1] / 2
                                           : 0;
        } else if (is_smaller > 0) {
            ++smallidx;
            smaller = smallnum;
            smallnum = kMagicInts[smallidx] / 2;
        }
        if (is_smaller != 0) {
            for (int d = 0; d < 3; ++d)
                sizesmall[d] = uint32_t(kMagicInts[smallidx]);
        }
    }
    return 36 + n_bytes + ((4 - n_bytes % 4) % 4);
}

}  // namespace

extern "C" {

// Scan frame offsets. out_info = [n_frames, n_atoms]. offsets may be null
// (count only) or an array of capacity max_frames. Returns 0 on success.
int xtc_scan(const char* path, int64_t* offsets, int64_t max_frames,
             int64_t* out_info) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    int64_t file_size = std::ftell(f);
    int64_t offset = 0;
    int64_t n_frames = 0;
    int64_t n_atoms_first = 0;
    unsigned char head[16];
    while (offset < file_size) {
        std::fseek(f, offset, SEEK_SET);
        if (std::fread(head, 1, 16, f) != 16) { std::fclose(f); return -2; }
        if (be32i(head) != 1995) { std::fclose(f); return -3; }
        int64_t n_atoms = be32i(head + 4);
        if (!n_atoms_first) n_atoms_first = n_atoms;
        if (offsets) {
            if (n_frames >= max_frames) { std::fclose(f); return -4; }
            offsets[n_frames] = offset;
        }
        ++n_frames;
        if (n_atoms <= 9) {
            offset += 56 + 12 * n_atoms;
        } else {
            unsigned char count[4];
            std::fseek(f, offset + 88, SEEK_SET);
            if (std::fread(count, 1, 4, f) != 4) {
                std::fclose(f);
                return -2;
            }
            int64_t n_bytes = be32i(count);
            offset += 92 + n_bytes + ((4 - n_bytes % 4) % 4);
        }
    }
    std::fclose(f);
    out_info[0] = n_frames;
    out_info[1] = n_atoms_first;
    return 0;
}

// Decode the frames at the given byte offsets. positions: n_indices *
// n_atoms * 3 floats (nm); boxes: n_indices * 9 floats or null; times:
// n_indices floats or null.
int xtc_read_frames(const char* path, const int64_t* frame_offsets,
                    int64_t n_indices, int64_t n_atoms, float* positions,
                    float* boxes, float* times) {
    // Seek-and-read per frame: random access into multi-gigabyte files
    // without loading them (the streaming data layer depends on this).
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t capacity = 92 + 12 * n_atoms + 1024;
    unsigned char* frame = static_cast<unsigned char*>(std::malloc(capacity));
    if (!frame) { std::fclose(f); return -1; }
    int status = 0;
    for (int64_t i = 0; i < n_indices; ++i) {
        std::fseek(f, frame_offsets[i], SEEK_SET);
        size_t header_len = n_atoms <= 9 ? 56 + 12 * n_atoms : 92;
        if (std::fread(frame, 1, header_len, f) != header_len) {
            status = -2;
            break;
        }
        if (be32i(frame) != 1995 || be32i(frame + 4) != n_atoms) {
            status = -3;
            break;
        }
        if (times) times[i] = be32f(frame + 12);
        if (boxes)
            for (int k = 0; k < 9; ++k)
                boxes[9 * i + k] = be32f(frame + 16 + 4 * k);
        if (n_atoms > 9) {
            int64_t n_bytes = be32i(frame + 88);
            int64_t payload = n_bytes + ((4 - n_bytes % 4) % 4);
            if (92 + payload > capacity) {
                capacity = 92 + payload + 1024;
                frame = static_cast<unsigned char*>(
                    std::realloc(frame, capacity));
                if (!frame) { std::fclose(f); return -1; }
            }
            if (std::fread(frame + 92, 1, payload, f)
                    != static_cast<size_t>(payload)) {
                status = -2;
                break;
            }
        }
        if (xtc_decompress(frame + 56, n_atoms,
                           positions + i * n_atoms * 3) < 0) {
            status = -5;
            break;
        }
    }
    std::free(frame);
    std::fclose(f);
    return status;
}

// TRR: scan coordinate-bearing frames. out_info = [n_frames, n_atoms].
int trr_scan(const char* path, int64_t* offsets, int64_t max_frames,
             int64_t* out_info) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    int64_t size = std::ftell(f);
    int64_t offset = 0;
    int64_t n_frames = 0;
    int64_t n_atoms_first = 0;
    unsigned char p[160];  // header-only reads; titles are short
    while (offset < size) {
        std::fseek(f, offset, SEEK_SET);
        if (std::fread(p, 1, sizeof(p), f) < 64) {
            std::fclose(f);
            return -2;
        }
        if (be32i(p) != 1993) { std::fclose(f); return -3; }
        int64_t title_len = be32i(p + 8);
        int64_t header = 12 + title_len + ((4 - title_len % 4) % 4);
        if (header + 52 > static_cast<int64_t>(sizeof(p))) {
            std::fclose(f);
            return -6;  // pathological title length
        }
        const unsigned char* h = p + header;
        int32_t ir_size = be32i(h), e_size = be32i(h + 4);
        int32_t box_size = be32i(h + 8), vir_size = be32i(h + 12);
        int32_t pres_size = be32i(h + 16), top_size = be32i(h + 20);
        int32_t sym_size = be32i(h + 24), x_size = be32i(h + 28);
        int32_t v_size = be32i(h + 32), f_size = be32i(h + 36);
        int32_t n_atoms = be32i(h + 40);
        int real_size = box_size ? box_size / 9
                        : (x_size ? x_size / (3 * n_atoms) : 4);
        int64_t frame_size = header + 52 + 2 * real_size + ir_size + e_size
            + box_size + vir_size + pres_size + top_size + sym_size
            + x_size + v_size + f_size;
        if (x_size) {
            if (offsets) {
                if (n_frames >= max_frames) { std::fclose(f); return -4; }
                offsets[n_frames] = offset;
            }
            ++n_frames;
            if (!n_atoms_first) n_atoms_first = n_atoms;
        }
        offset += frame_size;
    }
    std::fclose(f);
    out_info[0] = n_frames;
    out_info[1] = n_atoms_first;
    return 0;
}

// Decode TRR coordinate frames at the given offsets (positions nm; boxes
// 9 floats per frame or null; times or null).
int trr_read_frames(const char* path, const int64_t* frame_offsets,
                    int64_t n_indices, int64_t n_atoms, float* positions,
                    float* boxes, float* times) {
    // Seek-and-read per frame (see xtc_read_frames).
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // Generous fixed bound: header + 6 blocks of n_atoms double triples.
    int64_t capacity = 256 + 6 * (9 + 3 * n_atoms) * 8;
    unsigned char* data = static_cast<unsigned char*>(std::malloc(capacity));
    if (!data) { std::fclose(f); return -1; }
    int status = 0;
    for (int64_t i = 0; i < n_indices; ++i) {
        std::fseek(f, frame_offsets[i], SEEK_SET);
        int64_t got = std::fread(data, 1, capacity, f);
        if (got < 64) { status = -2; break; }
        const unsigned char* p = data;
        if (be32i(p) != 1993) { status = -3; break; }
        int64_t title_len = be32i(p + 8);
        const unsigned char* h = p + 12 + title_len
            + ((4 - title_len % 4) % 4);
        int32_t ir_size = be32i(h), e_size = be32i(h + 4);
        int32_t box_size = be32i(h + 8), vir_size = be32i(h + 12);
        int32_t pres_size = be32i(h + 16), top_size = be32i(h + 20);
        int32_t sym_size = be32i(h + 24), x_size = be32i(h + 28);
        int32_t frame_atoms = be32i(h + 40);
        if (frame_atoms != n_atoms || !x_size) { status = -5; break; }
        int real_size = box_size ? box_size / 9 : x_size / (3 * n_atoms);
        const unsigned char* body = h + 52 + 2 * real_size
            + ir_size + e_size;
        if (boxes) {
            for (int k = 0; k < 9; ++k)
                boxes[9 * i + k] = box_size == 0 ? 0.0f
                    : (real_size == 8 ? float(be64d(body + 8 * k))
                                      : be32f(body + 4 * k));
        }
        if (times)
            times[i] = real_size == 8 ? float(be64d(h + 52))
                                      : be32f(h + 52);
        const unsigned char* x = body + box_size + vir_size + pres_size
            + top_size + sym_size;
        float* out = positions + i * n_atoms * 3;
        for (int64_t k = 0; k < n_atoms * 3; ++k)
            out[k] = real_size == 8 ? float(be64d(x + 8 * k))
                                    : be32f(x + 4 * k);
    }
    std::free(data);
    std::fclose(f);
    return status;
}

}  // extern "C"
