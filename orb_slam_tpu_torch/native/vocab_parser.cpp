// Fast DBoW2 text-vocabulary parser (native runtime component).
//
// The reference loads ORBvoc.txt (~1M nodes) through a C++ std::istream
// parser at startup (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241,
// main.cc:94-108) and it is famously slow (minutes). This parser memory-maps
// the file and scans it with a branch-light integer/float reader, filling
// caller-allocated numpy buffers via a C ABI (ctypes).
//
// Format per line (after the "k L s w" header):
//   parent_id is_leaf d0 d1 ... d31 weight
//
// Exposed functions:
//   int vocab_count_nodes(const char* path, int* k, int* L)
//       -> number of non-root nodes (lines), or -1 on error.
//   int vocab_parse(const char* path, int n_nodes, int k,
//                   int32_t* parent, uint8_t* is_leaf,
//                   uint8_t* desc /* [n_nodes+1, 32] incl. root row 0 */,
//                   float* weight)
//       -> 0 on success. Node ids are 1-based (0 = root), matching the
//          Python loader's layout.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Scanner {
    const char* p;
    const char* end;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
    }
    bool done() {
        skip_ws();
        return p >= end;
    }
    long read_int() {
        skip_ws();
        bool neg = false;
        if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
        long v = 0;
        while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
        return neg ? -v : v;
    }
    double read_float() {
        skip_ws();
        char* q = nullptr;
        double v = strtod(p, &q);
        p = q;
        return v;
    }
    void skip_line() {
        while (p < end && *p != '\n') ++p;
    }
};

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok = false;

    explicit Mapped(const char* path) {
        fd = open(path, O_RDONLY);
        if (fd < 0) return;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size == 0) return;
        size = static_cast<size_t>(st.st_size);
        void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (m == MAP_FAILED) return;
        data = static_cast<const char*>(m);
        ok = true;
    }
    ~Mapped() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) close(fd);
    }
};

}  // namespace

extern "C" {

int vocab_count_nodes(const char* path, int* k, int* L) {
    Mapped m(path);
    if (!m.ok) return -1;
    Scanner s{m.data, m.data + m.size};
    *k = static_cast<int>(s.read_int());
    *L = static_cast<int>(s.read_int());
    s.read_int();  // scoring
    s.read_int();  // weighting
    s.skip_line();
    long n = 0;
    const char* p = s.p;
    bool in_line = false;
    while (p < m.data + m.size) {
        char c = *p++;
        if (c == '\n') {
            in_line = false;
        } else if (!in_line && c > ' ') {
            in_line = true;
            ++n;
        }
    }
    return static_cast<int>(n);
}

int vocab_parse(const char* path, int n_nodes, int k, int32_t* parent,
                uint8_t* is_leaf, uint8_t* desc, float* weight) {
    (void)k;
    Mapped m(path);
    if (!m.ok) return -1;
    Scanner s{m.data, m.data + m.size};
    s.read_int();
    s.read_int();
    s.read_int();
    s.read_int();  // header
    // root row
    memset(desc, 0, 32);
    for (int i = 0; i < n_nodes; ++i) {
        if (s.done()) return -2;
        parent[i] = static_cast<int32_t>(s.read_int());
        is_leaf[i] = static_cast<uint8_t>(s.read_int());
        uint8_t* d = desc + static_cast<size_t>(i + 1) * 32;
        for (int b = 0; b < 32; ++b) d[b] = static_cast<uint8_t>(s.read_int());
        weight[i] = static_cast<float>(s.read_float());
    }
    return 0;
}

}  // extern "C"
