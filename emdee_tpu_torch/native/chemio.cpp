// Native chemistry-file parsing (C++): PDB and XYZ → flat arrays.
//
// The native counterpart of emdee_tpu/io/{pdb,xyz}.py — the role the
// Chemfiles C++ library plays in the reference (modelling.jl:8,236-244):
// fast tokenization of large structure files into positions, names, residue
// ids, CONECT bonds, and the CRYST1 cell.  The Python parsers remain the
// behavioral spec; this implementation exists for throughput on big systems.
//
// C ABI (ctypes, see native/chemio.py).  Strings are returned as one
// "\x1f"-joined buffer per column.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Frame {
    std::vector<double> positions;   // 3N
    std::vector<double> velocities;  // 3N when has_velocities, else empty
    std::vector<std::string> names, resnames, chainids, elements;
    std::vector<long> resids;
    std::vector<uint8_t> is_hetatm;
    std::vector<long> bonds;  // 2B, 0-based
    double cell[6] = {0, 0, 0, 90, 90, 90};
    bool has_cell = false;
    bool has_velocities = false;
    std::string comment;
    // cached joined-string buffers (stable addresses for ctypes)
    mutable std::string joined[5];
};

std::string strip(const std::string& s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    if (a == std::string::npos) return "";
    size_t b = s.find_last_not_of(" \t\r\n");
    return s.substr(a, b - a + 1);
}

double field_f(const std::string& line, size_t start, size_t len) {
    if (line.size() <= start) return 0.0;
    return atof(strip(line.substr(start, len)).c_str());
}

long field_i(const std::string& line, size_t start, size_t len, long fallback = 0) {
    if (line.size() <= start) return fallback;
    std::string s = strip(line.substr(start, len));
    if (s.empty()) return fallback;
    return atol(s.c_str());
}

std::string field_s(const std::string& line, size_t start, size_t len) {
    if (line.size() <= start) return "";
    return strip(line.substr(start, std::min(len, line.size() - start)));
}

Frame* read_pdb_impl(const char* path) {
    std::ifstream in(path);
    if (!in) return nullptr;
    auto frame = new Frame();
    std::unordered_map<long, long> serial_to_index;
    std::unordered_set<uint64_t> bond_set;
    std::string line;
    while (std::getline(in, line)) {
        if (line.compare(0, 6, "ATOM  ") == 0 || line.compare(0, 6, "HETATM") == 0) {
            long index = static_cast<long>(frame->names.size());
            long serial = field_i(line, 6, 5, -1);
            if (serial >= 0) serial_to_index.emplace(serial, index);
            frame->names.push_back(field_s(line, 12, 4));
            frame->resnames.push_back(field_s(line, 17, 4));
            frame->chainids.push_back(line.size() > 21 ? line.substr(21, 1) : " ");
            frame->resids.push_back(field_i(line, 22, 4));
            frame->positions.push_back(field_f(line, 30, 8));
            frame->positions.push_back(field_f(line, 38, 8));
            frame->positions.push_back(field_f(line, 46, 8));
            frame->elements.push_back(line.size() >= 77 ? field_s(line, 76, 2) : "");
            frame->is_hetatm.push_back(line.compare(0, 6, "HETATM") == 0 ? 1 : 0);
        } else if (line.compare(0, 6, "CRYST1") == 0) {
            frame->cell[0] = field_f(line, 6, 9);
            frame->cell[1] = field_f(line, 15, 9);
            frame->cell[2] = field_f(line, 24, 9);
            frame->cell[3] = field_f(line, 33, 7);
            frame->cell[4] = field_f(line, 40, 7);
            frame->cell[5] = field_f(line, 47, 7);
            frame->has_cell = true;
        } else if (line.compare(0, 6, "CONECT") == 0) {
            long fields[5];
            int count = 0;
            for (int k = 0; k < 5; ++k) {
                long v = field_i(line, 6 + 5 * k, 5, -1);
                if (v >= 0) fields[count++] = v;
            }
            if (count >= 2) {
                auto it_a = serial_to_index.find(fields[0]);
                if (it_a != serial_to_index.end()) {
                    for (int k = 1; k < count; ++k) {
                        auto it_b = serial_to_index.find(fields[k]);
                        if (it_b == serial_to_index.end()) continue;
                        long i = it_a->second, j = it_b->second;
                        if (i == j) continue;
                        if (i > j) std::swap(i, j);
                        uint64_t key = (static_cast<uint64_t>(i) << 32) | static_cast<uint64_t>(j);
                        if (bond_set.insert(key).second) {
                            frame->bonds.push_back(i);
                            frame->bonds.push_back(j);
                        }
                    }
                }
            }
        } else if (line.compare(0, 3, "END") == 0) {
            break;
        }
    }
    // Sort bonds for deterministic order (matches the Python parser).
    std::vector<std::pair<long, long>> pairs;
    for (size_t k = 0; k + 1 < frame->bonds.size(); k += 2)
        pairs.emplace_back(frame->bonds[k], frame->bonds[k + 1]);
    std::sort(pairs.begin(), pairs.end());
    frame->bonds.clear();
    for (auto& [a, b] : pairs) {
        frame->bonds.push_back(a);
        frame->bonds.push_back(b);
    }
    return frame;
}

Frame* read_xyz_impl(const char* path) {
    std::ifstream in(path);
    if (!in) return nullptr;
    std::string line;
    if (!std::getline(in, line)) return nullptr;
    long n = atol(strip(line).c_str());
    if (n <= 0) return nullptr;
    auto frame = new Frame();
    std::getline(in, frame->comment);
    frame->positions.reserve(3 * n);
    frame->names.reserve(n);
    std::string name;
    double x, y, z, vx, vy, vz;
    // Extended-XYZ velocity columns (name x y z vx vy vz): present only when
    // EVERY record carries them (mirrors the Python spec in io/xyz.py;
    // the reference pulls velocities from its I/O frame, modelling.jl:240).
    frame->has_velocities = true;
    for (long i = 0; i < n; ++i) {
        if (!std::getline(in, line)) {
            delete frame;
            return nullptr;
        }
        std::istringstream ss(line);
        if (!(ss >> name >> x >> y >> z)) {
            delete frame;
            return nullptr;
        }
        frame->names.push_back(name);
        frame->positions.push_back(x);
        frame->positions.push_back(y);
        frame->positions.push_back(z);
        if (frame->has_velocities && (ss >> vx >> vy >> vz)) {
            frame->velocities.push_back(vx);
            frame->velocities.push_back(vy);
            frame->velocities.push_back(vz);
        } else {
            frame->has_velocities = false;
            frame->velocities.clear();
        }
    }
    frame->resids.assign(n, 1);
    frame->is_hetatm.assign(n, 0);
    return frame;
}

const char* joined_strings(const Frame* f, int which) {
    const std::vector<std::string>* col = nullptr;
    switch (which) {
        case 0: col = &f->names; break;
        case 1: col = &f->resnames; break;
        case 2: col = &f->chainids; break;
        case 3: col = &f->elements; break;
        case 4: {
            f->joined[4] = f->comment;
            return f->joined[4].c_str();
        }
        default: return nullptr;
    }
    std::string& buf = f->joined[which];
    buf.clear();
    for (size_t i = 0; i < col->size(); ++i) {
        if (i) buf.push_back('\x1f');
        buf += (*col)[i];
    }
    return buf.c_str();
}

}  // namespace

extern "C" {

void* emdee_read_pdb(const char* path) { return read_pdb_impl(path); }
void* emdee_read_xyz(const char* path) { return read_xyz_impl(path); }

long emdee_frame_natoms(void* h) {
    return static_cast<Frame*>(h)->names.size();
}
long emdee_frame_nbonds(void* h) {
    return static_cast<Frame*>(h)->bonds.size() / 2;
}
double* emdee_frame_positions(void* h) {
    return static_cast<Frame*>(h)->positions.data();
}
double* emdee_frame_velocities(void* h) {
    return static_cast<Frame*>(h)->velocities.data();
}
int emdee_frame_has_velocities(void* h) {
    return static_cast<Frame*>(h)->has_velocities ? 1 : 0;
}
long* emdee_frame_bonds(void* h) { return static_cast<Frame*>(h)->bonds.data(); }
long* emdee_frame_resids(void* h) { return static_cast<Frame*>(h)->resids.data(); }
uint8_t* emdee_frame_flags(void* h) {
    return static_cast<Frame*>(h)->is_hetatm.data();
}
double* emdee_frame_cell(void* h) { return static_cast<Frame*>(h)->cell; }
int emdee_frame_has_cell(void* h) {
    return static_cast<Frame*>(h)->has_cell ? 1 : 0;
}
const char* emdee_frame_strings(void* h, int which) {
    return joined_strings(static_cast<Frame*>(h), which);
}
void emdee_frame_free(void* h) { delete static_cast<Frame*>(h); }

}  // extern "C"
