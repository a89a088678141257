// Fast parser for raxml-ng .raxml.ancestralProbs TSV files.
//
// Native counterpart of the reference's strasser CSVReader usage
// (ipk/src/ar.cpp:191-270). The reference parses lazily one node block at a
// time; the device pipeline wants the whole [nodes, sites, sigma] tensor in one
// pass, and these files reach gigabytes for large trees, so parsing speed
// matters. This is a single-pass mmap + std::from_chars parser exposed with a
// C ABI for ctypes (ipk_tpu/ar/reader.py), ~30-60x faster than the Python
// fallback.
//
// Layout per row: Node\tSite\tState\tp_1 ... p_sigma\n  (one header line).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libprobs_parser.so probs_parser.cpp

#include <charconv>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct ParseState {
    std::vector<float> data;      // [rows, sigma]
    std::string labels;           // newline-joined node labels, block order
    std::vector<int64_t> rows_per_label;
    std::string error;
};

thread_local std::string g_error;

}  // namespace

extern "C" {

// Parses the file. On success returns an opaque handle; on failure returns
// nullptr (message via ipk_probs_error()).
void* ipk_probs_parse(const char* path, int64_t sigma) {
    g_error.clear();
    const int fd = ::open(path, O_RDONLY);
    if (fd < 0) {
        g_error = std::string("cannot open ") + path;
        return nullptr;
    }
    struct stat st;
    if (::fstat(fd, &st) != 0 || st.st_size == 0) {
        ::close(fd);
        g_error = std::string("cannot stat or empty: ") + path;
        return nullptr;
    }
    const size_t size = static_cast<size_t>(st.st_size);
    const char* base = static_cast<const char*>(
        ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    ::close(fd);
    if (base == MAP_FAILED) {
        g_error = std::string("mmap failed: ") + path;
        return nullptr;
    }

    auto* ps = new ParseState;
    const char* p = base;
    const char* end = base + size;

    // skip header line
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;

    std::string current;
    int64_t row_count = 0;
    bool ok = true;
    while (p < end) {
        if (*p == '\n') {  // tolerate blank lines
            ++p;
            continue;
        }
        // column 1: node label
        const char* label_start = p;
        while (p < end && *p != '\t') ++p;
        if (p >= end) break;
        const size_t label_len = static_cast<size_t>(p - label_start);
        if (current.size() != label_len ||
            std::memcmp(current.data(), label_start, label_len) != 0) {
            if (row_count) ps->rows_per_label.push_back(row_count);
            row_count = 0;
            current.assign(label_start, label_len);
            if (!ps->labels.empty()) ps->labels.push_back('\n');
            ps->labels.append(label_start, label_len);
        }
        ++p;
        // columns 2-3: Site, State — skip
        for (int skip = 0; skip < 2 && p < end; ++skip) {
            while (p < end && *p != '\t') ++p;
            if (p < end) ++p;
        }
        // sigma probability columns
        for (int64_t c = 0; c < sigma; ++c) {
            while (p < end && (*p == ' ' || *p == '\t')) ++p;
            float value;
            const auto res = std::from_chars(p, end, value);
            if (res.ec != std::errc()) {
                g_error = "float parse error near byte " +
                          std::to_string(p - base);
                ok = false;
                break;
            }
            ps->data.push_back(value);
            p = res.ptr;
        }
        if (!ok) break;
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
        ++row_count;
    }
    if (row_count) ps->rows_per_label.push_back(row_count);
    ::munmap(const_cast<char*>(base), size);
    if (!ok || ps->rows_per_label.empty()) {
        if (ok) g_error = std::string("no data rows in ") + path;
        delete ps;
        return nullptr;
    }
    return ps;
}

const char* ipk_probs_error() { return g_error.c_str(); }

int64_t ipk_probs_num_labels(void* handle) {
    return static_cast<ParseState*>(handle)->rows_per_label.size();
}

int64_t ipk_probs_num_values(void* handle) {
    return static_cast<ParseState*>(handle)->data.size();
}

const char* ipk_probs_labels(void* handle) {
    return static_cast<ParseState*>(handle)->labels.c_str();
}

const int64_t* ipk_probs_rows_per_label(void* handle) {
    return static_cast<ParseState*>(handle)->rows_per_label.data();
}

const float* ipk_probs_data(void* handle) {
    return static_cast<ParseState*>(handle)->data.data();
}

void ipk_probs_free(void* handle) { delete static_cast<ParseState*>(handle); }

}  // extern "C"
