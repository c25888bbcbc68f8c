// Native g2o tokenizer of boslam_torch (ctypes-loaded shared library; a copy
// of the JAX package's native/g2o_reader.cpp, so the port needs nothing
// of that package).
//
// Re-implements the record grammar of the reference parser
// (utils/g2o_utils.cpp:10-146) as a single-pass buffer scanner with no
// iostream overhead: the Python parser (io/g2o.py) is the behavioral
// reference; this exists for 100k-pose graphs, where Python-side
// tokenization dominates load time.  Parity details kept: bearing
// information weight fixed to 1 with the 4th numeric field ignored
// (g2o_utils.cpp:112-121), upper-triangular EDGE_SE2 omega mirrored
// (:79-109), bound = max|coord| + 3 over both vertex types (:34-67,134-135),
// last FIX wins (:70-76), unknown tags counted.
//
// Built at first use by boslam_torch/io/native.py (g++ -O2 -fPIC -shared).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

struct G2OArrays {
    int64_t n_poses;
    int64_t n_landmarks;
    int64_t n_bearing;
    int64_t n_odom;
    int64_t* pose_ids;
    float* pose_xyt;
    int64_t* lm_ids;
    float* lm_xy;
    int64_t* b_pose_id;
    int64_t* b_lm_id;
    float* b_meas;
    int64_t* o_src_id;
    int64_t* o_dst_id;
    float* o_meas;
    float* o_omega;
    int64_t fixed_pose_id;
    float bound;
    int64_t n_unknown;
};

}  // extern "C"

namespace {

struct Cursor {
    const char* p;
    const char* end;
};

inline void skip_ws(Cursor& c) {
    while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) c.p++;
}

inline bool at_eol(Cursor& c) { return c.p >= c.end || *c.p == '\n'; }

inline void skip_line(Cursor& c) {
    while (c.p < c.end && *c.p != '\n') c.p++;
    if (c.p < c.end) c.p++;
}

inline bool read_token(Cursor& c, const char*& tok, size_t& len) {
    skip_ws(c);
    if (at_eol(c)) return false;
    tok = c.p;
    while (c.p < c.end && *c.p != ' ' && *c.p != '\t' && *c.p != '\r' && *c.p != '\n')
        c.p++;
    len = (size_t)(c.p - tok);
    return true;
}

inline bool read_i64(Cursor& c, int64_t& out) {
    skip_ws(c);
    if (at_eol(c)) return false;
    char* endp = nullptr;
    out = strtoll(c.p, &endp, 10);
    if (endp == c.p) return false;
    c.p = endp;
    return true;
}

inline bool read_f(Cursor& c, float& out) {
    skip_ws(c);
    if (at_eol(c)) return false;
    char* endp = nullptr;
    out = strtof(c.p, &endp);
    if (endp == c.p) return false;
    c.p = endp;
    return true;
}

template <typename T>
T* steal(std::vector<T>& v) {
    T* out = (T*)malloc(v.size() * sizeof(T));
    if (!v.empty()) memcpy(out, v.data(), v.size() * sizeof(T));
    return out;
}

}  // namespace

extern "C" {

G2OArrays* boslam_parse_g2o(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf((size_t)size);
    if (size > 0 && fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    std::vector<int64_t> pose_ids, lm_ids, b_pose, b_lm, o_src, o_dst;
    std::vector<float> pose_xyt, lm_xy, b_meas, o_meas, o_omega;
    int64_t fixed_pose_id = -1;
    float bound = 0.0f;
    int64_t n_unknown = 0;

    Cursor c{buf.data(), buf.data() + buf.size()};
    const char* tok;
    size_t len;
    while (c.p < c.end) {
        if (!read_token(c, tok, len)) {  // empty line
            skip_line(c);
            continue;
        }
        if (len == 10 && memcmp(tok, "VERTEX_SE2", 10) == 0) {
            int64_t id;
            float x, y, t;
            if (read_i64(c, id) && read_f(c, x) && read_f(c, y) && read_f(c, t)) {
                if (fabsf(x) > bound) bound = fabsf(x);
                if (fabsf(y) > bound) bound = fabsf(y);
                pose_ids.push_back(id);
                pose_xyt.push_back(x);
                pose_xyt.push_back(y);
                pose_xyt.push_back(t);
            }
        } else if (len == 9 && memcmp(tok, "VERTEX_XY", 9) == 0) {
            int64_t id;
            float x, y;
            if (read_i64(c, id) && read_f(c, x) && read_f(c, y)) {
                if (fabsf(x) > bound) bound = fabsf(x);
                if (fabsf(y) > bound) bound = fabsf(y);
                lm_ids.push_back(id);
                lm_xy.push_back(x);
                lm_xy.push_back(y);
            }
        } else if (len == 3 && memcmp(tok, "FIX", 3) == 0) {
            int64_t id;
            if (read_i64(c, id)) fixed_pose_id = id;
        } else if (len == 8 && memcmp(tok, "EDGE_SE2", 8) == 0) {
            int64_t i, j;
            float x, y, t, o11, o12, o13, o22, o23, o33;
            if (read_i64(c, i) && read_i64(c, j) && read_f(c, x) && read_f(c, y) &&
                read_f(c, t) && read_f(c, o11) && read_f(c, o12) && read_f(c, o13) &&
                read_f(c, o22) && read_f(c, o23) && read_f(c, o33)) {
                o_src.push_back(i);
                o_dst.push_back(j);
                o_meas.push_back(x);
                o_meas.push_back(y);
                o_meas.push_back(t);
                const float om[9] = {o11, o12, o13, o12, o22, o23, o13, o23, o33};
                o_omega.insert(o_omega.end(), om, om + 9);
            }
        } else if (len == 19 && memcmp(tok, "EDGE_BEARING_SE2_XY", 19) == 0) {
            int64_t pid, lid;
            float brg;
            if (read_i64(c, pid) && read_i64(c, lid) && read_f(c, brg)) {
                // 4th numeric field deliberately ignored; omega defaults to 1
                b_pose.push_back(pid);
                b_lm.push_back(lid);
                b_meas.push_back(brg);
            }
        } else {
            n_unknown++;
        }
        skip_line(c);
    }
    bound += 3.0f;  // margin (g2o_utils.cpp:134-135)

    G2OArrays* out = (G2OArrays*)calloc(1, sizeof(G2OArrays));
    out->n_poses = (int64_t)pose_ids.size();
    out->n_landmarks = (int64_t)lm_ids.size();
    out->n_bearing = (int64_t)b_meas.size();
    out->n_odom = (int64_t)o_src.size();
    out->pose_ids = steal(pose_ids);
    out->pose_xyt = steal(pose_xyt);
    out->lm_ids = steal(lm_ids);
    out->lm_xy = steal(lm_xy);
    out->b_pose_id = steal(b_pose);
    out->b_lm_id = steal(b_lm);
    out->b_meas = steal(b_meas);
    out->o_src_id = steal(o_src);
    out->o_dst_id = steal(o_dst);
    out->o_meas = steal(o_meas);
    out->o_omega = steal(o_omega);
    out->fixed_pose_id = fixed_pose_id;
    out->bound = bound;
    out->n_unknown = n_unknown;
    return out;
}

void boslam_free_g2o(G2OArrays* a) {
    if (!a) return;
    free(a->pose_ids);
    free(a->pose_xyt);
    free(a->lm_ids);
    free(a->lm_xy);
    free(a->b_pose_id);
    free(a->b_lm_id);
    free(a->b_meas);
    free(a->o_src_id);
    free(a->o_dst_id);
    free(a->o_meas);
    free(a->o_omega);
    free(a);
}

}  // extern "C"
