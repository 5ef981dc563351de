// Native OBJ parser — the C++ equivalent of the reference's compiled Cython
// parser (reference: loadObject.pyx:3-131), exposed via a C ABI for ctypes.
//
// Semantics mirror the Python twin (models/obj.py) exactly, including:
//  * fan triangulation of n-gons: (f0, f1+i, f2+i)      (loadObject.pyx:53-67)
//  * face-index forms v/t/n, v//n, v/t/, v/t, v          (loadObject.pyx:69-108)
//  * 1-based indices with Python-list negative wraparound
//  * missing uv -> (0,0), missing normal -> (0,0,1)
//  * stored uv = (u, 1-v)                                (loadObject.pyx:109)
//  * 'v' lines take their LAST three fields              (loadObject.pyx:113-118)
//  * floats parsed at double precision then cast to f32 (matches Python's
//    float() -> np.float32 path bit-for-bit)
//
// Output layout: flat float32 array of [px,py,pz, nx,ny,nz, u,v] rows.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <fstream>

namespace {

// Pools hold doubles: the Python twin keeps values as Python floats
// (doubles) and only casts to float32 at the end, so computed values like
// 1 - v must round once, from double (matches bit-for-bit).
struct Vec3 { double x, y, z; };
struct Vec2 { double u, v; };

// Split a face token on '/' keeping empty fields (Python str.split("/")).
inline int split_slash(const char* s, const char* parts[3], int lens[3]) {
    int n = 0;
    const char* start = s;
    const char* p = s;
    for (;; ++p) {
        if (*p == '/' || *p == '\0') {
            if (n < 3) { parts[n] = start; lens[n] = (int)(p - start); }
            ++n;
            if (*p == '\0') break;
            start = p + 1;
        }
    }
    return n;  // number of fields (may exceed 3; extras ignored like Python[2])
}

inline long py_index(const char* s, int len, size_t pool_size, bool* ok) {
    // Python: pool[int(s) - 1] with negative wraparound.
    std::string tmp(s, (size_t)len);
    char* end = nullptr;
    long v = std::strtol(tmp.c_str(), &end, 10);
    if (end == tmp.c_str()) { *ok = false; return 0; }
    long idx = v - 1;
    if (idx < 0) idx += (long)pool_size;
    if (idx < 0 || (size_t)idx >= pool_size) { *ok = false; return 0; }
    *ok = true;
    return idx;
}

struct Tokenizer {
    std::vector<const char*> words;
    std::vector<int> lens;
    void tokenize(char* line) {
        words.clear();
        lens.clear();
        char* p = line;
        while (*p) {
            while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
            if (!*p) break;
            char* start = p;
            while (*p && *p != ' ' && *p != '\t' && *p != '\r') ++p;
            words.push_back(start);
            lens.push_back((int)(p - start));
        }
    }
};

inline double parse_f64(const char* s, int len) {
    std::string tmp(s, (size_t)len);
    return std::strtod(tmp.c_str(), nullptr);
}

struct Parser {
    std::vector<Vec3> vp, vn;
    std::vector<Vec2> vt;
    std::vector<float> out;

    bool get_vertex(const char* face, int flen) {
        std::string tok(face, (size_t)flen);
        const char* parts[3];
        int lens[3];
        int n = split_slash(tok.c_str(), parts, lens);

        bool ok = true;
        Vec3 v;
        Vec2 t{0.0f, 0.0f};
        Vec3 nn{0.0f, 0.0f, 1.0f};

        long vi = py_index(parts[0], lens[0], vp.size(), &ok);
        if (!ok) return false;
        v = vp[(size_t)vi];

        // Exactly mirror the Python twin's branch structure
        // (models/obj.py: len(f) == 3 / == 2 / else): a token with MORE
        // than three fields falls through to the defaults branch.
        if (n == 3) {
            if (lens[1] > 0) {
                long ti = py_index(parts[1], lens[1], vt.size(), &ok);
                if (!ok) return false;
                t = vt[(size_t)ti];
            }
            if (lens[2] > 0) {
                long ni = py_index(parts[2], lens[2], vn.size(), &ok);
                if (!ok) return false;
                nn = vn[(size_t)ni];
            }
        } else if (n == 2) {
            long ti = py_index(parts[1], lens[1], vt.size(), &ok);
            if (!ok) return false;
            t = vt[(size_t)ti];
        }

        out.push_back((float)v.x); out.push_back((float)v.y); out.push_back((float)v.z);
        out.push_back((float)nn.x); out.push_back((float)nn.y); out.push_back((float)nn.z);
        out.push_back((float)t.u); out.push_back((float)(1.0 - t.v));
        return true;
    }
};

}  // namespace

extern "C" {

// Returns the number of floats written (N*8), or a negative error code:
// -1 file not found, -2 malformed face index.  *out must be freed with
// obj_free.  progress != 0 prints the reference's carriage-return percent
// bar (loadObject.pyx:20-21; percent here is bytes-consumed, equivalent to
// the reference's line counter for monotonic progress) and a closing
// newline (loadObject.pyx:48).
long long obj_parse(const char* path, void** out, int progress) {
    std::ifstream f(path);
    if (!f.is_open()) return -1;

    long long fsize = 0;
    if (progress) {
        f.seekg(0, std::ios::end);
        fsize = (long long)f.tellg();
        f.seekg(0, std::ios::beg);
        if (fsize <= 0) progress = 0;
    }
    long long consumed = 0;
    long long next_mark = progress ? fsize / 100 : 0;
    if (next_mark < 1) next_mark = 1;
    long long mark = next_mark;

    Parser ps;
    Tokenizer tk;
    std::string line;
    while (std::getline(f, line)) {
        if (progress) {
            consumed += (long long)line.size() + 1;
            if (consumed >= mark) {
                std::printf("\r%.2f %%", (double)consumed / (double)fsize * 100.0);
                std::fflush(stdout);
                while (mark <= consumed) mark += next_mark;
            }
        }
        tk.tokenize(line.data());
        if (tk.words.empty()) continue;
        const char* w0 = tk.words[0];
        int l0 = tk.lens[0];
        size_t nw = tk.words.size();
        if (l0 == 1 && w0[0] == 'v' && nw >= 4) {
            // last three fields (loadObject.pyx:113-118)
            ps.vp.push_back({parse_f64(tk.words[nw - 3], tk.lens[nw - 3]),
                             parse_f64(tk.words[nw - 2], tk.lens[nw - 2]),
                             parse_f64(tk.words[nw - 1], tk.lens[nw - 1])});
        } else if (l0 == 2 && w0[0] == 'v' && w0[1] == 't' && nw >= 3) {
            ps.vt.push_back({parse_f64(tk.words[1], tk.lens[1]),
                             parse_f64(tk.words[2], tk.lens[2])});
        } else if (l0 == 2 && w0[0] == 'v' && w0[1] == 'n' && nw >= 4) {
            ps.vn.push_back({parse_f64(tk.words[1], tk.lens[1]),
                             parse_f64(tk.words[2], tk.lens[2]),
                             parse_f64(tk.words[3], tk.lens[3])});
        } else if (l0 == 1 && w0[0] == 'f' && nw >= 4) {
            // fan triangulation (loadObject.pyx:53-67)
            size_t tris = nw - 3;  // (nw-1 corners) - 2
            for (size_t i = 0; i < tris; ++i) {
                if (!ps.get_vertex(tk.words[1], tk.lens[1])) return -2;
                if (!ps.get_vertex(tk.words[2 + i], tk.lens[2 + i])) return -2;
                if (!ps.get_vertex(tk.words[3 + i], tk.lens[3 + i])) return -2;
            }
        }
    }

    if (progress) std::printf("\n");

    float* buf = (float*)std::malloc(ps.out.size() * sizeof(float));
    if (!buf) return -3;
    std::memcpy(buf, ps.out.data(), ps.out.size() * sizeof(float));
    *out = buf;
    return (long long)ps.out.size();
}

void obj_free(void* p) { std::free(p); }

}  // extern "C"
