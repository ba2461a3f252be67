// c2v_extract — native path-context extractor CLI.
//
// Drop-in for the reference's JVM invocation (SURVEY.md §2 L0):
//   java -jar JavaExtractor.jar --max_path_length 8 --max_path_width 2
//        --dir <d> --num_threads N   (or --file <f>)
// emits one line per method to stdout: `name tok,pathHash,tok ...`.

#include <atomic>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <iostream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "parser.h"
#include "paths.h"

namespace fs = std::filesystem;

namespace {

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::string ProcessSource(const std::string& src,
                          const c2v::ExtractOptions& opts) {
  c2v::ParseResult pr = c2v::ParseJava(src);
  auto features = c2v::ExtractFeatures(pr.ast, pr.method_nodes, opts);
  std::string out;
  for (const auto& mf : features) {
    out += c2v::RenderLine(mf);
    out.push_back('\n');
  }
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  c2v::ExtractOptions opts;
  std::string dir, file;
  int num_threads = static_cast<int>(std::thread::hardware_concurrency());
  bool no_hash = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      return (i + 1 < argc) ? argv[++i] : "";
    };
    auto next_int = [&](int* out) -> bool {
      std::string v = next();
      try {
        *out = std::stoi(v);
        return true;
      } catch (...) {
        std::cerr << "bad integer for " << a << ": '" << v << "'\n";
        return false;
      }
    };
    if (a == "--dir") dir = next();
    else if (a == "--file") file = next();
    else if (a == "--max_path_length") {
      if (!next_int(&opts.max_path_length)) return 2;
    } else if (a == "--max_path_width") {
      if (!next_int(&opts.max_path_width)) return 2;
    } else if (a == "--num_threads") {
      if (!next_int(&num_threads)) return 2;
    } else if (a == "--max_leaves") {
      if (!next_int(&opts.max_leaves)) return 2;
    }
    else if (a == "--no_hash") no_hash = true;
    else if (a == "--help" || a == "-h") {
      std::cout << "usage: c2v_extract (--dir D | --file F) "
                   "[--max_path_length 8] [--max_path_width 2] "
                   "[--num_threads N] [--max_leaves 1000] [--no_hash]\n";
      return 0;
    } else {
      std::cerr << "unknown flag: " << a << "\n";
      return 2;
    }
  }
  opts.hash_paths = !no_hash;

  if (!file.empty()) {
    std::error_code ec;
    if (!fs::is_regular_file(file, ec)) {
      std::cerr << "cannot read file: " << file << "\n";
      return 2;
    }
    std::cout << ProcessSource(ReadFile(file), opts);
    return 0;
  }
  if (dir.empty()) {
    std::cerr << "need --dir or --file\n";
    return 2;
  }

  std::vector<std::string> files;
  std::error_code ec;
  for (auto it = fs::recursive_directory_iterator(
           dir, fs::directory_options::skip_permission_denied, ec);
       it != fs::recursive_directory_iterator(); it.increment(ec)) {
    if (ec) break;
    if (it->is_regular_file(ec) && it->path().extension() == ".java")
      files.push_back(it->path().string());
  }

  // thread pool over files (reference: --num_threads 64 in preprocess.sh)
  std::atomic<size_t> next_idx{0};
  std::mutex out_mu;
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        size_t i = next_idx.fetch_add(1);
        if (i >= files.size()) return;
        std::string out = ProcessSource(ReadFile(files[i]), opts);
        if (!out.empty()) {
          std::lock_guard<std::mutex> lock(out_mu);
          std::cout << out;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}
