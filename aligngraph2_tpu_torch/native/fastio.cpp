// Fast FASTA/FASTQ loader: single pass over an mmap'd file producing
// 2-bit base codes (A=0 C=1 G=2 T=3, other=0), per-sequence offsets and
// first-token names.  This is the host data-loader of the framework —
// the native counterpart of the reference's SeqHelper/CompressedSeq
// (AlignGraph2 PAGraph/src/tools/seq/SeqHelper.cpp,
// CompressedSeq.cpp), reachable from Python via ctypes (io/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC fastio.cpp -o libfastio.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct SeqDB {
    uint8_t *codes;      // concatenated 2-bit codes (one byte per base)
    int64_t *offsets;    // n_seqs + 1
    char *names;         // '\0'-joined first tokens
    int64_t n_seqs;
    int64_t total_len;
    int64_t names_len;
};

uint8_t g_enc[256];

struct EncInit {
    EncInit() {
        memset(g_enc, 0, sizeof(g_enc));
        g_enc[(unsigned)'C'] = g_enc[(unsigned)'c'] = 1;
        g_enc[(unsigned)'G'] = g_enc[(unsigned)'g'] = 2;
        g_enc[(unsigned)'T'] = g_enc[(unsigned)'t'] = 3;
    }
} g_enc_init;

struct Buf {
    char *data = nullptr;
    size_t len = 0, cap = 0;
    void push(const char *p, size_t n) {
        if (len + n > cap) {
            cap = (len + n) * 2 + 64;
            data = (char *)realloc(data, cap);
        }
        memcpy(data + len, p, n);
        len += n;
    }
    void push1(char c) { push(&c, 1); }
};

// first whitespace-delimited token of [p, end)
inline const char *token_end(const char *p, const char *end) {
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
    return p;
}

inline const char *line_end(const char *p, const char *end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    return nl ? nl : end;
}

}  // namespace

extern "C" {

SeqDB *agv_load(const char *path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
        close(fd);
        return nullptr;
    }
    const char *base =
        (const char *)mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE,
                           fd, 0);
    close(fd);
    if (base == MAP_FAILED) return nullptr;
    const char *p = base, *end = base + st.st_size;

    Buf codes, names;
    int64_t *offsets = (int64_t *)malloc(sizeof(int64_t) * 16);
    size_t off_cap = 16, n_seqs = 0;
    offsets[0] = 0;
    auto add_offset = [&](int64_t v) {
        if (n_seqs + 2 > off_cap) {
            off_cap *= 2;
            offsets = (int64_t *)realloc(offsets, sizeof(int64_t) * off_cap);
        }
        offsets[++n_seqs] = v;
    };

    char first = *p;
    if (first == '>' || first == ';') {  // FASTA (multi-line)
        while (p < end) {
            if (*p == '>' || *p == ';') {
                const char *le = line_end(p, end);
                const char *te = token_end(p + 1, le);
                names.push(p + 1, te - (p + 1));
                names.push1('\0');
                p = le < end ? le + 1 : end;
                while (p < end && *p != '>' && *p != ';') {
                    const char *le2 = line_end(p, end);
                    for (const char *q = p; q < le2; ++q) {
                        if (*q != '\r') codes.push1((char)g_enc[(uint8_t)*q]);
                    }
                    p = le2 < end ? le2 + 1 : end;
                }
                add_offset((int64_t)codes.len);
            } else {
                p = line_end(p, end);
                if (p < end) ++p;
            }
        }
    } else if (first == '@') {  // FASTQ (strict 4-line)
        while (p < end && *p == '@') {
            const char *le = line_end(p, end);
            const char *te = token_end(p + 1, le);
            const char *l2 = le < end ? le + 1 : end;
            const char *l2e = line_end(l2, end);
            const char *l3 = l2e < end ? l2e + 1 : end;
            const char *l3e = line_end(l3, end);
            const char *l4 = l3e < end ? l3e + 1 : end;
            const char *l4e = line_end(l4, end);
            if (l4 >= end) break;  // incomplete record
            names.push(p + 1, te - (p + 1));
            names.push1('\0');
            for (const char *q = l2; q < l2e; ++q) {
                if (*q != '\r') codes.push1((char)g_enc[(uint8_t)*q]);
            }
            add_offset((int64_t)codes.len);
            p = l4e < end ? l4e + 1 : end;
        }
    }
    munmap((void *)base, st.st_size);

    SeqDB *db = (SeqDB *)malloc(sizeof(SeqDB));
    db->codes = (uint8_t *)codes.data;
    db->offsets = offsets;
    db->names = names.data;
    db->n_seqs = (int64_t)n_seqs;
    db->total_len = (int64_t)codes.len;
    db->names_len = (int64_t)names.len;
    return db;
}

void agv_free(SeqDB *db) {
    if (!db) return;
    free(db->codes);
    free(db->offsets);
    free(db->names);
    free(db);
}

int64_t agv_n_seqs(SeqDB *db) { return db->n_seqs; }
int64_t agv_total_len(SeqDB *db) { return db->total_len; }
int64_t agv_names_len(SeqDB *db) { return db->names_len; }
uint8_t *agv_codes(SeqDB *db) { return db->codes; }
int64_t *agv_offsets(SeqDB *db) { return db->offsets; }
char *agv_names(SeqDB *db) { return db->names; }

}  // extern "C"
